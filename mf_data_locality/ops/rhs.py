"""Right-hand-side assembly and L2-error evaluation by quadrature.

The reference defers a "proper right hand side that allows us to compute a
manufactured solution" to a TODO (``benchmark.h:168-169``) and fills a
synthetic vector instead.  A complete framework needs consistent source-term
assembly, so this module provides

    rhs_i = sum_q w_q det(J_q) f(x_q) phi_i(q)

and the matching L2-error functional — both with the same sum-factorized
machinery as the operator (interpolate/integrate with S, on-the-fly trilinear
metric).  Used by the convergence tests (L2 error ~ h^{p+1}).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import geometry, lagrange


def _quad_data(layout: DofLayout, n_q: int | None):
    p = layout.degree
    q = n_q if n_q is not None else p + 2
    shape = lagrange.make_shape(p, q)
    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    x_q = geometry.map_points(coeffs[:, None], uvw[None])  # (nc, q^3, 3)
    jac = geometry.jacobian(coeffs[:, None], uvw[None])
    det = np.linalg.det(jac)
    return shape, q, uvw, w3, x_q, det


def assemble_rhs(layout: DofLayout,
                 f: Callable[[np.ndarray], np.ndarray],
                 n_q: int | None = None,
                 apply_constraints: bool = True) -> np.ndarray:
    """Consistent load vector for source ``f``: (C, n_nodes) float64.

    ``f`` maps points (..., 3) to values (..., C).
    """
    shape, q, uvw, w3, x_q, det = _quad_data(layout, n_q)
    fv = np.asarray(f(x_q))  # (nc, q^3, C)
    if fv.ndim == 2:
        fv = fv[..., None]
    n_comp = fv.shape[-1]
    integrand = fv * (w3[None, :, None] * det[..., None])  # (nc, q^3, C)

    # integrate: multiply by basis values, S^T along each axis
    nc = layout.mesh.n_cells
    t = integrand.reshape(nc, q, q, q, n_comp)
    S = shape.values
    t = np.einsum("qi,nqabc->niabc", S, t)  # z
    t = np.einsum("qj,niqbc->nijbc", S, t)  # y
    t = np.einsum("qk,nijqc->nijkc", S, t)  # x
    local = t.reshape(nc, -1, n_comp)

    out = np.zeros((layout.n_nodes, n_comp))
    np.add.at(out, layout.gather_map.reshape(-1),
              local.reshape(-1, n_comp))
    if apply_constraints:
        out[layout.boundary_node_mask] = 0.0
    return out.T  # (C, n_nodes)


def l2_error(layout: DofLayout, u_nodes: np.ndarray,
             u_exact: Callable[[np.ndarray], np.ndarray],
             n_q: int | None = None) -> float:
    """L2 norm of (u_h - u_exact) over the mesh by quadrature.

    ``u_nodes``: (C, n_nodes) nodal coefficients.
    """
    shape, q, uvw, w3, x_q, det = _quad_data(layout, n_q)
    nc = layout.mesh.n_cells
    p1 = layout.degree + 1
    u_loc = u_nodes.T[layout.gather_map]  # (nc, nloc, C)
    n_comp = u_loc.shape[-1]
    t = u_loc.reshape(nc, p1, p1, p1, n_comp)
    S = shape.values
    t = np.einsum("qi,nijkc->nqjkc", S, t)
    t = np.einsum("qj,najkc->naqkc", S, t)
    t = np.einsum("qk,nabkc->nabqc", S, t)
    uh_q = t.reshape(nc, -1, n_comp)
    ue_q = np.asarray(u_exact(x_q))
    if ue_q.ndim == 2:
        ue_q = ue_q[..., None]
    diff2 = ((uh_q - ue_q) ** 2).sum(axis=-1)
    return float(np.sqrt((diff2 * w3[None, :] * det).sum()))
