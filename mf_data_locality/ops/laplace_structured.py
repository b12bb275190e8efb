"""Structured-lattice fast path for the BP4 operator: zero gather/scatter.

This is the JAX answer to the reference's compressed vector access
(``common_code/vector_access_reduced.h``): on the structured benchmark meshes
the DoF vector is stored as the 3D node lattice ``(C, Nz, Ny, Nx)``, so

* per-cell extraction ("gather") is a reshape + one strided slice per axis
  (cells overlap only at shared node planes), and
* the transpose accumulation ("scatter-add") is two non-overlapping
  reshape-adds per axis — no ``scatter`` instruction anywhere.

Everything on the hot path is therefore batched matmuls over the lattice
plus pointwise metric math — the layout *is* the locality
optimization (capability slot of ``renumber_dofs_for_mf.h``: memory is
touched in sweep order by construction).

Extraction and contraction are interleaved axis-by-axis so the intermediate
blowup per step is only q/p (interpolating to the quadrature lattice), never
the full (p+1)^3-fold duplication a cell-wise gather would create.

Validated against the general gather/scatter path in the tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import geometry, lagrange
from mf_data_locality.ops.laplace import apply_axis


class StructuredOperatorData(NamedTuple):
    """Pytree of device arrays for the lattice-layout operator."""

    values: jax.Array  # S: (q, p+1)
    d_col: jax.Array  # (q, q)
    q_pts: jax.Array  # (q,) 1D quadrature points
    w3: jax.Array  # (1, qz, 1, qy, 1, qx) tensor weights (broadcast layout)
    coeffs: jax.Array  # (ncz, 1, ncy, 1, ncx, 1, 8, 3) trilinear coefficients
    mask: jax.Array  # (1, Nz, Ny, Nx) 1.0 where unconstrained


def make_structured_operator(
    layout: DofLayout, n_q: int | None = None, dtype=jnp.float32
) -> StructuredOperatorData:
    p = layout.degree
    q = n_q if n_q is not None else p + 2
    shape = lagrange.make_shape(p, q)
    w = shape.q_weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :])
    ncz, ncy, ncx = layout.mesh.n_cells_axis
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    coeffs = coeffs.reshape(ncz, 1, ncy, 1, ncx, 1, 8, 3)
    nz, ny, nx = layout.n_nodes_axis
    mask = (~layout.boundary_node_mask).reshape(1, nz, ny, nx)
    return StructuredOperatorData(
        values=jnp.asarray(shape.values, dtype=dtype),
        d_col=jnp.asarray(shape.d_col, dtype=dtype),
        q_pts=jnp.asarray(shape.q_points, dtype=dtype),
        w3=jnp.asarray(w3.reshape(1, q, 1, q, 1, q), dtype=dtype),
        coeffs=jnp.asarray(coeffs, dtype=dtype),
        mask=jnp.asarray(mask, dtype=dtype),
    )


def cellify(u: jax.Array, axis: int, p: int) -> jax.Array:
    """Split a node axis of size N = nc*p + 1 into (nc, p+1) overlapping windows.

    Window i of cell c is node ``c*p + i``; consecutive cells share one node.
    Pure reshape + one strided slice — the structured-mesh "gather".  The new
    (nc, p+1) pair replaces ``axis`` in place.
    """
    n = u.shape[axis]
    nc = (n - 1) // p
    main = jax.lax.slice_in_dim(u, 0, nc * p, axis=axis)
    main = main.reshape(u.shape[:axis] + (nc, p) + u.shape[axis + 1:])
    last = jax.lax.slice_in_dim(u, p, n, stride=p, axis=axis)  # nodes p, 2p, ...
    last = jnp.expand_dims(last, axis + 1)
    return jnp.concatenate([main, last], axis=axis + 1)


def overlap_add(v: jax.Array, axis: int, p: int) -> jax.Array:
    """Adjoint of :func:`cellify`: accumulate (nc, p+1) windows onto N nodes.

    Shared nodes between consecutive cells receive both contributions via one
    add of two shifted reshapes — the structured-mesh "scatter-add", with no
    scatter instruction.  ``v`` has the (nc, p+1) pair at (axis, axis+1).
    """
    nc = v.shape[axis]
    flat_shape = v.shape[:axis] + (nc * p,) + v.shape[axis + 2:]

    # windows 0..p-1 tile nodes 0..nc*p-1 disjointly; append node N-1 slot
    main = jax.lax.slice_in_dim(v, 0, p, axis=axis + 1).reshape(flat_shape)
    zero1 = jnp.zeros(v.shape[:axis] + (1,) + v.shape[axis + 2:], v.dtype)
    main = jnp.concatenate([main, zero1], axis=axis)  # (..., N, ...)

    # window p of cell c lands on node (c+1)*p: zero-pad to stride p, shift by p
    lastcol = jax.lax.slice_in_dim(v, p, p + 1, axis=axis + 1)
    if p > 1:
        padz = jnp.zeros(v.shape[:axis] + (nc, p - 1) + v.shape[axis + 2:], v.dtype)
        lastcol = jnp.concatenate([lastcol, padz], axis=axis + 1)
    last = lastcol.reshape(flat_shape)
    zerop = jnp.zeros(v.shape[:axis] + (p,) + v.shape[axis + 2:], v.dtype)
    last = jnp.concatenate([zerop, last], axis=axis)
    last = jax.lax.slice_in_dim(last, 0, nc * p + 1, axis=axis)
    return main + last


def _metric_apply(op: StructuredOperatorData, gx, gy, gz):
    """Apply G = det(J) w J^{-1} J^{-T} pointwise, fully scalarized.

    Equivalent to the reference per-q-point sequence (Jacobian from the
    trilinear polynomial, ``do_invert``, two 3x3 applications —
    ``poisson_operator.h:596-631``) but expressed on nine broadcastable
    component arrays so every intermediate keeps the large lattice axes
    minor-most.  Uses the adjugate directly: G = (w/det) adj(J) adj(J)^T.
    """
    q = op.q_pts.shape[0]
    uq = op.q_pts.reshape(1, 1, 1, 1, 1, q)
    vq = op.q_pts.reshape(1, 1, 1, q, 1, 1)
    wq = op.q_pts.reshape(1, q, 1, 1, 1, 1)

    c = [[op.coeffs[..., i, d] for d in range(3)] for i in range(8)]
    # J[d][e] = dx_d/d(u,v,w)_e of the trilinear map (geometry.jacobian,
    # unrolled per component)
    j = [[None] * 3 for _ in range(3)]
    for d in range(3):
        j[d][0] = c[1][d] + c[3][d] * vq + c[5][d] * wq + c[7][d] * (vq * wq)
        j[d][1] = c[2][d] + c[3][d] * uq + c[6][d] * wq + c[7][d] * (uq * wq)
        j[d][2] = c[4][d] + c[5][d] * uq + c[6][d] * vq + c[7][d] * (uq * vq)

    # adjugate (transposed cofactors): adj[e][d] such that J^{-1} = adj / det
    adj = [[None] * 3 for _ in range(3)]
    adj[0][0] = j[1][1] * j[2][2] - j[1][2] * j[2][1]
    adj[0][1] = j[0][2] * j[2][1] - j[0][1] * j[2][2]
    adj[0][2] = j[0][1] * j[1][2] - j[0][2] * j[1][1]
    adj[1][0] = j[1][2] * j[2][0] - j[1][0] * j[2][2]
    adj[1][1] = j[0][0] * j[2][2] - j[0][2] * j[2][0]
    adj[1][2] = j[0][2] * j[1][0] - j[0][0] * j[1][2]
    adj[2][0] = j[1][0] * j[2][1] - j[1][1] * j[2][0]
    adj[2][1] = j[0][1] * j[2][0] - j[0][0] * j[2][1]
    adj[2][2] = j[0][0] * j[1][1] - j[0][1] * j[1][0]
    det = j[0][0] * adj[0][0] + j[0][1] * adj[1][0] + j[0][2] * adj[2][0]
    scale = op.w3 / det

    # G_ef = scale * sum_b adj[e][b] adj[f][b]  (symmetric, 6 unique entries)
    def gmat(e, f):
        return scale * (adj[e][0] * adj[f][0] + adj[e][1] * adj[f][1]
                        + adj[e][2] * adj[f][2])

    g00, g01, g02 = gmat(0, 0), gmat(0, 1), gmat(0, 2)
    g11, g12, g22 = gmat(1, 1), gmat(1, 2), gmat(2, 2)
    tx = g00 * gx + g01 * gy + g02 * gz
    ty = g01 * gx + g11 * gy + g12 * gz
    tz = g02 * gx + g12 * gy + g22 * gz
    return tx, ty, tz


def apply_lattice(op: StructuredOperatorData, u: jax.Array) -> jax.Array:
    """Weak vector-Laplacian on the lattice (no constraint handling).

    ``u``: (C, Nz, Ny, Nx) -> same shape.  Axis plan (the structured analog of
    the reference hot loop, ``poisson_operator.h:534-666``):

      cellify+interpolate per axis ->
      (C, ncz, qz, ncy, qy, ncx, qx) quadrature lattice ->
      collocation gradients -> on-the-fly trilinear metric -> transpose.
    """
    p1 = op.values.shape[1]
    p = p1 - 1

    # forward: cellify + S along x, y, z (axes of u are 1=z, 2=y, 3=x)
    t = cellify(u, 3, p)  # (C, Nz, Ny, ncx, p+1)
    t = apply_axis(op.values, t, 4)  # (C, Nz, Ny, ncx, qx)
    t = cellify(t, 2, p)  # (C, Nz, ncy, p+1, ncx, qx)
    t = apply_axis(op.values, t, 3)  # (C, Nz, ncy, qy, ncx, qx)
    t = cellify(t, 1, p)  # (C, ncz, p+1, ncy, qy, ncx, qx)
    t = apply_axis(op.values, t, 2)  # (C, ncz, qz, ncy, qy, ncx, qx)

    # collocation gradients on the quadrature lattice
    gx = apply_axis(op.d_col, t, 6)
    gy = apply_axis(op.d_col, t, 4)
    gz = apply_axis(op.d_col, t, 2)

    # metric: J at each (cell, q-point) from 24 floats/cell, fused elementwise.
    # Deliberately *scalarized* — no stacked (..., 3, 3) axes: nine separate
    # broadcast arrays keep the large lattice axes minor-most and fuse into
    # elementwise kernels, where tiny trailing dims would not.
    tx, ty, tz = _metric_apply(op, gx, gy, gz)

    # transpose: D^T per direction summed, then S^T + overlap-add per axis
    t = (apply_axis(op.d_col.T, tx, 6)
         + apply_axis(op.d_col.T, ty, 4)
         + apply_axis(op.d_col.T, tz, 2))
    t = apply_axis(op.values.T, t, 2)  # (C, ncz, p+1, ncy, qy, ncx, qx)
    t = overlap_add(t, 1, p)  # (C, Nz, ncy, qy, ncx, qx)
    t = apply_axis(op.values.T, t, 3)
    t = overlap_add(t, 2, p)  # (C, Nz, Ny, ncx, qx)
    t = apply_axis(op.values.T, t, 4)
    t = overlap_add(t, 3, p)  # (C, Nz, Ny, Nx)
    return t


def vmult(op: StructuredOperatorData, u: jax.Array,
          constrained_identity: bool = True) -> jax.Array:
    """Full operator on the lattice layout; semantics match :func:`laplace.vmult`."""
    v = apply_lattice(op, u * op.mask) * op.mask
    if constrained_identity:
        v = v + u * (1.0 - op.mask)
    return v


def to_lattice(u_flat: jax.Array, layout: DofLayout) -> jax.Array:
    """(C, n_nodes) -> (C, Nz, Ny, Nx) (pure reshape — flat order is lattice order)."""
    nz, ny, nx = layout.n_nodes_axis
    return u_flat.reshape(u_flat.shape[0], nz, ny, nx)


def to_flat(u_lat: jax.Array) -> jax.Array:
    """(C, Nz, Ny, Nx) -> (C, n_nodes)."""
    return u_lat.reshape(u_lat.shape[0], -1)
