"""Matrix-free vector-Laplace operator (CEED BP4), general-mesh path.

Capability of ``Poisson::LaplaceOperator`` (reference:
``common_code/poisson_operator.h:74-695``): sum-factorized application of the
``n_components``-component Laplacian with on-the-fly trilinear geometry.

Structure (re-expressed for XLA, not a translation):

* The reference's SIMD cell batches become the leading cell axis of batched
  contractions; each 1D sum-factorization step is one batched matmul (the
  even-odd scalar factorization the reference uses is a CPU FMA-count
  optimization).
* Gather/scatter uses per-cell node maps with ``.at[].add`` scatter-adds
  (conflict-free accumulation is XLA's job); the structured-lattice fast path
  in :mod:`laplace_structured` removes them entirely.
* Geometry: 8 trilinear coefficient vectors per cell, Jacobian rebuilt at
  every quadrature point in registers (``poisson_operator.h:577-604``).

All functions are pure and jit-friendly; :class:`LaplaceOperatorData` is a
pytree of device arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import geometry, lagrange


class LaplaceOperatorData(NamedTuple):
    """Device-side state of the operator (a pytree; shapes are jit-static)."""

    values: jax.Array  # S: (q, p+1) basis values at quadrature points
    d_col: jax.Array  # (q, q) collocation derivative on the quadrature grid
    q_uvw: jax.Array  # (q^3, 3) tensor quadrature points, (u,v,w) per point
    q_w3: jax.Array  # (q^3,) tensor quadrature weights
    coeffs: jax.Array  # (n_cells, 8, 3) trilinear geometry coefficients
    gather: jax.Array  # (n_cells, (p+1)^3) int32 cell-to-node map
    unconstrained: jax.Array  # (n_nodes,) 1.0 where free, 0.0 where Dirichlet
    # transposed scatter map: for each node, the positions of its (cell,
    # local-dof) copies in the flattened cell-local output, padded to the
    # max node multiplicity (8 for conforming hex meshes).  Turns the
    # scatter-add into KMAX gathers + a sum — deterministic, where a
    # duplicate-index scatter-add sums in a run-dependent order (atomics on
    # the GPU), and gathers vectorize (the capability of
    # distribute_local_to_global_compressed, vector_access_reduced.h:293-531,
    # realized as a precomputed conflict-free structure)
    scatter_pos: jax.Array | None = None  # (n_nodes, KMAX) int32
    scatter_valid: jax.Array | None = None  # (n_nodes, KMAX) 0/1


def make_operator(
    layout: DofLayout,
    n_q: int | None = None,
    dtype=jnp.float32,
) -> LaplaceOperatorData:
    """Build operator data for a DoF layout; default quadrature q = p + 2.

    (q = p + 2 is the BP4 protocol, ``benchmark.h:290-313``.)
    """
    p = layout.degree
    q = n_q if n_q is not None else p + 2
    shape = lagrange.make_shape(p, q)
    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    q_uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    q_w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)
    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    pos, valid = _transposed_scatter_map(np.asarray(layout.gather_map),
                                         layout.n_nodes)
    return LaplaceOperatorData(
        values=jnp.asarray(shape.values, dtype=dtype),
        d_col=jnp.asarray(shape.d_col, dtype=dtype),
        q_uvw=jnp.asarray(q_uvw, dtype=dtype),
        q_w3=jnp.asarray(q_w3, dtype=dtype),
        coeffs=jnp.asarray(coeffs, dtype=dtype),
        gather=jnp.asarray(layout.gather_map),
        unconstrained=jnp.asarray(~layout.boundary_node_mask, dtype=dtype),
        scatter_pos=jnp.asarray(pos),
        scatter_valid=jnp.asarray(valid, dtype=dtype),
    )


def renumber_operator(op: "LaplaceOperatorData",
                      perm: np.ndarray) -> "LaplaceOperatorData":
    """Operator for the node numbering new_id = perm[old_id].

    Permutes the gather map and the constraint mask AND rebuilds the
    transposed scatter map (``scatter_pos``/``scatter_valid`` index the
    flattened cell-local output by node id, so a stale map scatters to
    the wrong nodes — the capability analog of re-running
    ``renumber_dofs_for_mf.h`` after a renumbering).
    """
    from mf_data_locality.mesh import renumber as rn

    gm2 = rn.apply_permutation(np.asarray(op.gather), np.asarray(perm))
    mask2 = rn.permute_nodes(np.asarray(op.unconstrained), np.asarray(perm))
    n_nodes = op.unconstrained.shape[0]
    pos, valid = _transposed_scatter_map(gm2, n_nodes)
    # an operator built without the transposed scatter map (fields default
    # to None in the NamedTuple) gets both rebuilt here rather than an
    # AttributeError on scatter_valid.dtype
    vdtype = (op.scatter_valid.dtype if op.scatter_valid is not None
              else op.unconstrained.dtype)
    return op._replace(gather=jnp.asarray(gm2),
                       unconstrained=jnp.asarray(mask2, op.unconstrained.dtype),
                       scatter_pos=jnp.asarray(pos),
                       scatter_valid=jnp.asarray(valid, vdtype))


def _transposed_scatter_map(gather_map: np.ndarray, n_nodes: int
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Invert a (n_cells, nloc) gather map into per-node copy positions.

    Returns ``pos`` (n_nodes, KMAX) int32 indices into the flattened
    (n_cells * nloc) local output and ``valid`` (n_nodes, KMAX) 0/1 —
    KMAX = max node multiplicity (8 for a conforming hex mesh: a vertex
    node shared by up to 8 cells).  Unused slots point at position 0 with
    valid = 0.
    """
    flat = gather_map.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    sorted_nodes = flat[order]
    counts = np.bincount(sorted_nodes, minlength=n_nodes)
    kmax = int(counts.max()) if counts.size else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.zeros((n_nodes, kmax), np.int32)
    valid = np.zeros((n_nodes, kmax), np.float64)
    # slot index of each sorted entry within its node's run
    slot = np.arange(flat.size) - np.repeat(starts, counts)
    pos[sorted_nodes, slot] = order.astype(np.int32)
    valid[sorted_nodes, slot] = 1.0
    return pos, valid


def apply_axis(mat: jax.Array, arr: jax.Array, axis: int) -> jax.Array:
    """Contract ``arr``'s ``axis`` with ``mat``'s second index (batched matmul).

    HIGHEST precision: at default precision an f32 contraction may run in
    TF32 on the GPU (about 3 decimal digits), which would poison CG iteration
    counts.
    """
    out = jnp.tensordot(mat, arr, axes=((1,), (axis,)),
                        precision=jax.lax.Precision.HIGHEST)
    return jnp.moveaxis(out, 0, axis)


def metric_terms(op: LaplaceOperatorData) -> jax.Array:
    """G = det(J) * w * J^{-1} J^{-T} at all quadrature points: (n_cells, q^3, 3, 3).

    Evaluated on the fly from the 24 geometry floats per cell — the data-
    locality trade the reference makes (store O(1) per cell, recompute per q).
    """
    jac = geometry.jacobian(op.coeffs[:, None], op.q_uvw[None])  # (nc, q3, 3, 3)
    jinv, det = geometry.invert_3x3(jac)
    scale = (det * op.q_w3[None, :])[..., None, None]
    return scale * jnp.einsum("...ab,...cb->...ac", jinv, jinv,
                              precision=jax.lax.Precision.HIGHEST)


def local_apply(op: LaplaceOperatorData, u_loc: jax.Array) -> jax.Array:
    """Per-cell weak Laplacian: (C, n_cells, p+1, p+1, p+1) -> same shape.

    The 3D hot loop of the reference (``poisson_operator.h:534-666``):
    interpolate -> collocation gradients -> metric contraction -> transpose.
    Local axes are (component, cell, z, y, x) — component-leading so the
    large cell/lattice axes stay minor-most (contiguous).
    """
    q = op.d_col.shape[0]
    n_comp, nc = u_loc.shape[0], u_loc.shape[1]

    # interpolate values to the quadrature lattice, one batched matmul per axis
    uq = apply_axis(op.values, u_loc, 2)
    uq = apply_axis(op.values, uq, 3)
    uq = apply_axis(op.values, uq, 4)

    # collocation gradients on the quadrature lattice (reference: D_col after S)
    gx = apply_axis(op.d_col, uq, 4)
    gy = apply_axis(op.d_col, uq, 3)
    gz = apply_axis(op.d_col, uq, 2)
    grad = jnp.stack([gx, gy, gz], axis=0)  # (3ref, C, nc, qz, qy, qx)
    grad = grad.reshape(3, n_comp, nc, q * q * q)

    # metric application, pointwise over (cell, q-point)
    tmp = jnp.einsum("nqef,fcnq->ecnq", metric_terms(op), grad,
                     precision=jax.lax.Precision.HIGHEST)
    tmp = tmp.reshape(3, n_comp, nc, q, q, q)

    # transpose sweep: D^T per direction, summed, then S^T along every axis
    vq = (apply_axis(op.d_col.T, tmp[0], 4)
          + apply_axis(op.d_col.T, tmp[1], 3)
          + apply_axis(op.d_col.T, tmp[2], 2))
    vq = apply_axis(op.values.T, vq, 2)
    vq = apply_axis(op.values.T, vq, 3)
    vq = apply_axis(op.values.T, vq, 4)
    return vq


def apply_cells(op: LaplaceOperatorData, u: jax.Array) -> jax.Array:
    """Gather -> local apply -> transposed-gather accumulate.

    ``u``: (C, n_nodes).  The cell-local output is accumulated back via the
    precomputed per-node copy positions (KMAX gathers + sum) instead of a
    duplicate-index ``.at[].add`` scatter, whose summation order is not
    fixed.
    """
    nc, nloc = op.gather.shape
    p1 = round(nloc ** (1 / 3))
    n_comp = u.shape[0]
    u_loc = u[:, op.gather].reshape(n_comp, nc, p1, p1, p1)
    v_loc = local_apply(op, u_loc)
    v_flat = v_loc.reshape(n_comp, nc * nloc)
    if op.scatter_pos is None:
        out = jnp.zeros_like(u)
        return out.at[:, op.gather.reshape(-1)].add(v_flat)
    return jnp.sum(v_flat[:, op.scatter_pos]
                   * op.scatter_valid[None].astype(v_flat.dtype), axis=-1)


def vmult(op: LaplaceOperatorData, u: jax.Array,
          constrained_identity: bool = True) -> jax.Array:
    """Full operator: A u = M K M u (+ (I - M) u), M = unconstrained mask.

    Matches the reference ``vmult`` semantics: constrained DoFs read as zero,
    receive no contributions, and (optionally) copy through the input
    (``poisson_operator.h:307-313``).  The merged-CG path uses
    ``constrained_identity=False`` exactly as ``vmult_with_merged_sums`` does.
    ``u``: (C, n_nodes).
    """
    mask = op.unconstrained[None, :]
    v = apply_cells(op, u * mask) * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v


def tvmult(op: LaplaceOperatorData, u: jax.Array) -> jax.Array:
    """Transpose apply — the operator is symmetric (poisson_operator.h:383-387)."""
    return vmult(op, u)


def vmult_add(op: LaplaceOperatorData, dst: jax.Array, src: jax.Array) -> jax.Array:
    """dst += A src with identity on constrained rows.

    Parity slot of ``poisson_operator.h:318-325``; in the reference this
    method references an undefined ``local_apply_linear_geo`` and is never
    instantiated (templates), i.e. it is dead code there — provided here as a
    working accumulate variant.
    """
    mask = op.unconstrained[None, :]
    return dst + apply_cells(op, src * mask) * mask + src * (1.0 - mask)


# ---------------------------------------------------------------------------
# Dense reference assembly (validation only; float64 NumPy, independent path)
# ---------------------------------------------------------------------------


def assemble_dense(layout: DofLayout, n_q: int | None = None,
                   apply_constraints: bool = True,
                   rule: str = "gauss") -> np.ndarray:
    """Dense scalar stiffness matrix by straightforward quadrature assembly.

    Deliberately *not* sum-factorized — an independent implementation used to
    validate the matrix-free kernels on tiny meshes.  Returns the scalar
    (one-component) matrix of shape (n_nodes, n_nodes); the vector operator is
    block-diagonal with this block per component.  ``rule="gll"`` reproduces
    the under-integrated GLL(p+1) operator the preconditioner diagonal is
    built from (``benchmark.h:124-154``).
    """
    p = layout.degree
    if rule == "gll":
        shape = lagrange.make_shape_gll(p)
        q = p + 1
    else:
        q = n_q if n_q is not None else p + 2
        shape = lagrange.make_shape(p, q)
    nloc = (p + 1) ** 3

    # full basis gradient table: grad_phi[a, qpt, e]
    V, D = shape.values, shape.grads
    gphi = np.zeros((nloc, q**3, 3))
    a = 0
    for k in range(p + 1):  # z
        for j in range(p + 1):  # y
            for i in range(p + 1):  # x
                gu = np.einsum("c,b,a->cba", V[:, k], V[:, j], D[:, i]).reshape(-1)
                gv = np.einsum("c,b,a->cba", V[:, k], D[:, j], V[:, i]).reshape(-1)
                gw = np.einsum("c,b,a->cba", D[:, k], V[:, j], V[:, i]).reshape(-1)
                gphi[a] = np.stack([gu, gv, gw], axis=-1)
                a += 1

    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)

    coeffs = geometry.trilinear_coefficients(layout.mesh.cell_vertices)
    jac = geometry.jacobian(coeffs[:, None], uvw[None])
    jinv, det = geometry.invert_3x3(jac)
    G = (det * w3[None])[..., None, None] * np.einsum("...ab,...cb->...ac", jinv, jinv)

    K_loc = np.einsum("aqe,nqef,bqf->nab", gphi, G, gphi)  # (n_cells, nloc, nloc)

    n = layout.n_nodes
    K = np.zeros((n, n))
    gmap = layout.gather_map
    for c in range(layout.mesh.n_cells):
        idx = gmap[c]
        K[np.ix_(idx, idx)] += K_loc[c]

    if apply_constraints:
        m = layout.boundary_node_mask
        K[m, :] = 0.0
        K[:, m] = 0.0
        K[m, m] = 1.0
    return K
