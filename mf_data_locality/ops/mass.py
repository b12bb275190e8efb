"""Matrix-free mass operator (CEED BP1/BP2 family).

The reference implements only BP3/BP4 (stiffness); the CEED bake-off family
it belongs to (https://ceed.exascaleproject.org/bps) pairs them with the mass
-matrix problems BP1/BP2.  With the framework's machinery the mass apply is
one interpolation, a pointwise det(J) w scaling, and the transpose — provided
here for family completeness and as the L2-projection building block.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import geometry, lagrange
from mf_data_locality.ops.laplace import apply_axis


class MassOperatorData(NamedTuple):
    values: jax.Array  # (q, p+1)
    detw: jax.Array  # (n_cells, q^3): det(J) * w at quadrature points
    gather: jax.Array  # (n_cells, (p+1)^3)
    unconstrained: jax.Array  # (n_nodes,)


def make_mass_operator(layout: DofLayout, n_q: int | None = None,
                       dtype=jnp.float32) -> MassOperatorData:
    p = layout.degree
    q = n_q if n_q is not None else p + 2
    shape = lagrange.make_shape(p, q)
    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    jac = geometry.jacobian(coeffs[:, None], uvw[None])
    det = np.linalg.det(jac)
    return MassOperatorData(
        values=jnp.asarray(shape.values, dtype=dtype),
        detw=jnp.asarray(det * w3[None, :], dtype=dtype),
        gather=jnp.asarray(layout.gather_map),
        unconstrained=jnp.asarray(~layout.boundary_node_mask, dtype=dtype),
    )


def apply_cells(op: MassOperatorData, u: jax.Array) -> jax.Array:
    """M u without constraint handling; ``u``: (C, n_nodes)."""
    nc, nloc = op.gather.shape
    p1 = round(nloc ** (1 / 3))
    q = op.values.shape[0]
    n_comp = u.shape[0]
    t = u[:, op.gather].reshape(n_comp, nc, p1, p1, p1)
    t = apply_axis(op.values, t, 2)
    t = apply_axis(op.values, t, 3)
    t = apply_axis(op.values, t, 4)
    t = t * op.detw.reshape(1, nc, q, q, q)
    t = apply_axis(op.values.T, t, 2)
    t = apply_axis(op.values.T, t, 3)
    t = apply_axis(op.values.T, t, 4)
    out = jnp.zeros_like(u)
    return out.at[:, op.gather.reshape(-1)].add(t.reshape(n_comp, nc * nloc))


def vmult(op: MassOperatorData, u: jax.Array,
          constrained_identity: bool = True) -> jax.Array:
    """Full mass operator with Dirichlet masking (BP2 = 3 components)."""
    mask = op.unconstrained[None, :]
    v = apply_cells(op, u * mask) * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v
