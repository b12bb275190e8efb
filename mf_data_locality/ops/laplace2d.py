"""2D vector-Laplace operator on quadrilateral meshes.

Capability parity with the reference operator's dim == 2 path
(``poisson_operator.h:136-149`` bilinear geometry; ``:472-533`` the 2D apply):
sum-factorized application with on-the-fly bilinear geometry, general
gather/scatter.  The reference ships no 2D benchmark executable, so this is a
capability module (with dense validation in the tests), not a tuned hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mf_data_locality.mesh import manifold
from mf_data_locality.ops import lagrange
from mf_data_locality.ops.laplace import apply_axis


@dataclass(frozen=True)
class BoxMesh2D:
    """Structured quad mesh on a rectangle, optionally sine-deformed."""

    n_cells_axis: tuple[int, int]  # (ncy, ncx)
    spacing: float
    deformed: bool = True
    factor: float = manifold.DEFAULT_FACTOR

    @property
    def n_cells(self) -> int:
        return self.n_cells_axis[0] * self.n_cells_axis[1]

    @cached_property
    def vertex_lattice(self) -> np.ndarray:
        ncy, ncx = self.n_cells_axis
        y = np.arange(ncy + 1) * self.spacing
        x = np.arange(ncx + 1) * self.spacing
        Y, X = np.meshgrid(y, x, indexing="ij")
        pts = np.stack([X, Y], axis=-1)
        if self.deformed:
            pts = manifold.push_forward(pts, self.factor)  # 2D product of sines
        return pts

    @cached_property
    def cell_vertices(self) -> np.ndarray:
        """(n_cells, 4, 2); local corner order bit0->x, bit1->y."""
        lat = self.vertex_lattice
        ncy, ncx = self.n_cells_axis
        out = np.empty((ncy, ncx, 4, 2))
        for v in range(4):
            dx, dy = v & 1, (v >> 1) & 1
            out[..., v, :] = lat[dy:dy + ncy, dx:dx + ncx, :]
        return out.reshape(-1, 4, 2)


@dataclass(frozen=True)
class DofLayout2D:
    mesh: BoxMesh2D
    degree: int

    @property
    def n_nodes_axis(self) -> tuple[int, int]:
        ncy, ncx = self.mesh.n_cells_axis
        return (self.degree * ncy + 1, self.degree * ncx + 1)

    @property
    def n_nodes(self) -> int:
        ny, nx = self.n_nodes_axis
        return ny * nx

    @cached_property
    def gather_map(self) -> np.ndarray:
        p = self.degree
        ncy, ncx = self.mesh.n_cells_axis
        ny, nx = self.n_nodes_axis
        cy, cx = np.meshgrid(np.arange(ncy), np.arange(ncx), indexing="ij")
        base = (p * cy) * nx + p * cx
        j, i = np.meshgrid(np.arange(p + 1), np.arange(p + 1), indexing="ij")
        local = j * nx + i
        return (base.reshape(-1, 1) + local.reshape(1, -1)).astype(np.int32)

    @cached_property
    def boundary_node_mask(self) -> np.ndarray:
        ny, nx = self.n_nodes_axis
        m = np.zeros((ny, nx), dtype=bool)
        m[0] = m[-1] = True
        m[:, 0] = m[:, -1] = True
        return m.reshape(-1)


def bilinear_coefficients(cell_vertices: np.ndarray) -> np.ndarray:
    """x(u, v) = c0 + c1 u + c2 v + c3 uv; (..., 4, 2).

    The 2D analog of ``poisson_operator.h:136-149`` (constant + linear +
    bilinear terms of the quadratic slot table).
    """
    v = np.asarray(cell_vertices, dtype=np.float64)
    c = np.empty_like(v)
    c[..., 0, :] = v[..., 0, :]
    c[..., 1, :] = v[..., 1, :] - v[..., 0, :]
    c[..., 2, :] = v[..., 2, :] - v[..., 0, :]
    c[..., 3, :] = v[..., 3, :] - v[..., 2, :] - v[..., 1, :] + v[..., 0, :]
    return c


class Laplace2DData(NamedTuple):
    values: jax.Array  # (q, p+1)
    d_col: jax.Array  # (q, q)
    q_uv: jax.Array  # (q^2, 2)
    q_w2: jax.Array  # (q^2,)
    coeffs: jax.Array  # (nc, 4, 2)
    gather: jax.Array  # (nc, (p+1)^2)
    unconstrained: jax.Array  # (n_nodes,)


def make_operator2d(layout: DofLayout2D, n_q: int | None = None,
                    dtype=jnp.float64) -> Laplace2DData:
    p = layout.degree
    q = n_q if n_q is not None else p + 2
    shape = lagrange.make_shape(p, q)
    qy, qx = np.meshgrid(shape.q_points, shape.q_points, indexing="ij")
    q_uv = np.stack([qx, qy], axis=-1).reshape(-1, 2)
    w = shape.q_weights
    q_w2 = (w[:, None] * w[None, :]).reshape(-1)
    coeffs = bilinear_coefficients(layout.mesh.cell_vertices)
    return Laplace2DData(
        values=jnp.asarray(shape.values, dtype=dtype),
        d_col=jnp.asarray(shape.d_col, dtype=dtype),
        q_uv=jnp.asarray(q_uv, dtype=dtype),
        q_w2=jnp.asarray(q_w2, dtype=dtype),
        coeffs=jnp.asarray(coeffs, dtype=dtype),
        gather=jnp.asarray(layout.gather_map),
        unconstrained=jnp.asarray(~layout.boundary_node_mask, dtype=dtype),
    )


def _metric2d(op: Laplace2DData):
    """G = det(J) w J^{-1} J^{-T} at quadrature points: (nc, q^2, 2, 2)."""
    u = op.q_uv[None, :, 0:1]
    v = op.q_uv[None, :, 1:2]
    c = op.coeffs  # (nc, 4, 2)
    # J[d][e] = dx_d / d(u,v)_e
    col0 = c[:, None, 1, :] + c[:, None, 3, :] * v  # (nc, q2, 2) = dx/du
    col1 = c[:, None, 2, :] + c[:, None, 3, :] * u
    j00, j10 = col0[..., 0], col0[..., 1]
    j01, j11 = col1[..., 0], col1[..., 1]
    det = j00 * j11 - j01 * j10
    scale = op.q_w2[None, :] / det
    # adj(J): [[j11, -j01], [-j10, j00]]; G = scale * adj adj^T
    g00 = scale * (j11 * j11 + j01 * j01)
    g01 = scale * (-j11 * j10 - j01 * j00)
    g11 = scale * (j10 * j10 + j00 * j00)
    return g00, g01, g11


def local_apply2d(op: Laplace2DData, u_loc: jax.Array) -> jax.Array:
    """(C, nc, p+1, p+1) -> same; 2D analog of poisson_operator.h:472-533."""
    q = op.d_col.shape[0]
    n_comp, nc = u_loc.shape[0], u_loc.shape[1]
    uq = apply_axis(op.values, u_loc, 2)
    uq = apply_axis(op.values, uq, 3)
    gx = apply_axis(op.d_col, uq, 3).reshape(n_comp, nc, q * q)
    gy = apply_axis(op.d_col, uq, 2).reshape(n_comp, nc, q * q)
    g00, g01, g11 = _metric2d(op)
    tx = (g00[None] * gx + g01[None] * gy).reshape(n_comp, nc, q, q)
    ty = (g01[None] * gx + g11[None] * gy).reshape(n_comp, nc, q, q)
    vq = apply_axis(op.d_col.T, tx, 3) + apply_axis(op.d_col.T, ty, 2)
    vq = apply_axis(op.values.T, vq, 2)
    vq = apply_axis(op.values.T, vq, 3)
    return vq


def vmult2d(op: Laplace2DData, u: jax.Array,
            constrained_identity: bool = True) -> jax.Array:
    """Full 2D operator; ``u``: (C, n_nodes)."""
    mask = op.unconstrained[None, :]
    um = u * mask
    nc, nloc = op.gather.shape
    p1 = round(nloc ** 0.5)
    n_comp = u.shape[0]
    u_loc = um[:, op.gather].reshape(n_comp, nc, p1, p1)
    v_loc = local_apply2d(op, u_loc)
    out = jnp.zeros_like(u)
    out = out.at[:, op.gather.reshape(-1)].add(
        v_loc.reshape(n_comp, nc * nloc))
    v = out * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v


def assemble_dense2d(layout: DofLayout2D, n_q: int | None = None,
                     apply_constraints: bool = True) -> np.ndarray:
    """Independent dense scalar assembly for validation (float64 NumPy)."""
    p = layout.degree
    q = n_q if n_q is not None else p + 2
    shape = lagrange.make_shape(p, q)
    nloc = (p + 1) ** 2
    V, D = shape.values, shape.grads
    gphi = np.zeros((nloc, q**2, 2))
    a = 0
    for j in range(p + 1):
        for i in range(p + 1):
            gu = np.einsum("b,a->ba", V[:, j], D[:, i]).reshape(-1)
            gv = np.einsum("b,a->ba", D[:, j], V[:, i]).reshape(-1)
            gphi[a] = np.stack([gu, gv], axis=-1)
            a += 1

    qy, qx = np.meshgrid(shape.q_points, shape.q_points, indexing="ij")
    uv = np.stack([qx, qy], axis=-1).reshape(-1, 2)
    w = shape.q_weights
    w2 = (w[:, None] * w[None, :]).reshape(-1)
    c = bilinear_coefficients(layout.mesh.cell_vertices)
    col0 = c[:, None, 1, :] + c[:, None, 3, :] * uv[None, :, 1:2]
    col1 = c[:, None, 2, :] + c[:, None, 3, :] * uv[None, :, 0:1]
    J = np.stack([col0, col1], axis=-1)  # (nc, q2, 2, 2)
    Jinv = np.linalg.inv(J)
    det = np.linalg.det(J)
    G = (det * w2[None])[..., None, None] * np.einsum(
        "...ab,...cb->...ac", Jinv, Jinv)
    K_loc = np.einsum("aqe,nqef,bqf->nab", gphi, G, gphi)

    n = layout.n_nodes
    K = np.zeros((n, n))
    for ci, idx in enumerate(layout.gather_map):
        K[np.ix_(idx, idx)] += K_loc[ci]
    if apply_constraints:
        m = layout.boundary_node_mask
        K[m, :] = 0.0
        K[:, m] = 0.0
        K[m, m] = 1.0
    return K
