"""Distributed BP4: z-slab domain decomposition over a 1D device mesh.

The JAX equivalent of the reference's MPI layer (SURVEY.md §2
"parallelism strategies", §5 "distributed communication backend"):

* **p4est partition -> z-slab partition.** The structured mesh is split into
  equal slabs of cells along z; each device owns one slab.  The locality
  renumbering's goal — contiguous halo data (``renumber_dofs_for_mf.h:
  492-535``) — holds by construction: the halo is one contiguous (Ny, Nx)
  node plane.
* **Ghost exchange -> two one-plane ppermutes.** Vectors are stored as
  per-device slabs of P+1 node planes where the plane shared by neighboring
  devices is *replicated* (the deal.II partitioner's ghost row).  After a
  local operator apply, the shared plane holds partial sums on both sides:
  one ``ppermute`` sends the lower partial up to be summed, a second sends
  the completed plane back down — the compress/update_ghost_values pair of
  ``MatrixFree::cell_loop`` (``poisson_operator.h:310,339``).
* **7-scalar allreduce -> one psum.** The merged CG's reduction hook becomes
  ``psum`` over the mesh axis; non-owned replicated planes are zero-weighted
  in the local dot products so each global DoF counts once (the partitioner's
  owned-range split).

State invariant: for every distributed vector, plane P of device d equals
plane 0 of device d+1.  All update arithmetic is elementwise, so the
invariant is preserved automatically; the operator apply restores it after
the halo sum.

Everything runs inside one ``shard_map`` region over ``Mesh(devices, ("z",))``
— collectives compile to XLA collectives (NCCL on GPUs), and the whole CG
loop stays on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mf_data_locality.mesh.box import BoxMesh
from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import diagonal, laplace_structured
from mf_data_locality.ops.laplace_structured import apply_lattice
from mf_data_locality.solvers import cg, cg_merged

AXIS = "z"


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DistributedBP4:
    """Per-device stacked problem state; leading axis D is sharded over "z"."""

    op_stack: Any  # operator pytree, each leaf (D, ...)
    inv_diag: jax.Array  # (D, 1, P+1, Ny, Nx)
    b: jax.Array  # (D, C, P+1, Ny, Nx)
    weight: jax.Array  # (D, 1, P+1, 1, 1): 1 on owned planes, 0 on ghosts
    n_dofs: int = field(metadata=dict(static=True), default=0)
    n_cells: int = field(metadata=dict(static=True), default=0)
    n_devices: int = field(metadata=dict(static=True), default=1)
    ncz_global: int = field(metadata=dict(static=True), default=0)
    """Real global z-cell-layer count (excludes dummy padding layers)."""


def _cells_per_slab(layout: DofLayout, n_dev: int) -> int:
    """z-cell layers per device slab: ceil(ncz / n_dev).

    Arbitrary device counts are supported (the reference runs any MPI rank
    count via p4est partitioning, ``benchmark.h:79``): when ncz does not
    divide evenly, trailing slabs carry dummy z-layers — unit-geometry cells
    (``poisson_operator.h:269-280``), zero Dirichlet-style masks and zero
    dot weights — so every device holds identically-shaped arrays.
    """
    ncz, ncy, ncx = layout.mesh.n_cells_axis
    return -(-ncz // n_dev)


def build_distributed(s: int, degree: int, n_devices: int | None = None,
                      dtype=jnp.float32, n_components: int = 3,
                      devices=None, box: BoxMesh | None = None
                      ) -> tuple[DistributedBP4, Mesh]:
    """Partition the BP4 problem over a 1D device mesh.

    Arrays are built globally (host NumPy), split into z-slabs with the
    shared-plane replication, stacked on a leading device axis, and placed
    with a NamedSharding so each device holds exactly its slab.
    """
    devs = list(devices if devices is not None else jax.devices())
    D = n_devices or len(devs)
    if len(devs) < D:
        raise ValueError(f"requested {D} devices, only {len(devs)} available")
    devs = devs[:D]
    mesh = Mesh(np.array(devs), (AXIS,))

    layout = DofLayout(box if box is not None else BoxMesh.from_s(s), degree)
    ncz, ncy, ncx = layout.mesh.n_cells_axis
    ncz_loc = _cells_per_slab(layout, D)
    p = degree
    nz, ny, nx = layout.n_nodes_axis
    Pp = ncz_loc * p  # owned planes per device (except the extra top plane)

    # global host-side setup (same path as single-device bp4.build)
    n = layout.n_nodes
    dof_index = (np.arange(n)[:, None] * n_components
                 + np.arange(n_components)[None, :])
    b = (dof_index % 8).astype(np.float64)
    b[layout.boundary_node_mask] = 0.0
    b_lat = b.T.reshape(n_components, nz, ny, nx)
    inv_diag = np.asarray(diagonal.compute_inverse_diagonal(layout, dtype=jnp.float64))
    inv_lat = inv_diag.reshape(1, nz, ny, nx)
    mask_lat = (~layout.boundary_node_mask).reshape(1, nz, ny, nx)

    def slab(arr):
        """(C, Nz, Ny, Nx) -> (D, C, P+1, Ny, Nx), shared-plane replication.

        Slabs past the global top (non-divisible device counts) are padded
        with zero planes — dummy layers with zero mask/weight.
        """
        return np.stack([_pad_slice(arr, 1, d * Pp, Pp + 1)
                         for d in range(D)])

    weight = np.ones((D, 1, Pp + 1, 1, 1))
    weight[1:, :, 0] = 0.0  # bottom plane of d>0 is owned by the device below
    for d in range(D):  # planes past the global top are dummies
        for j in range(Pp + 1):
            if d * Pp + j >= nz:
                weight[d, :, j] = 0.0

    # per-device operator data: slab coefficient/mask arrays + shared matrices
    ops = []
    for d in range(D):
        slab_mesh = BoxMesh(n_cells_axis=(ncz_loc, ncy, ncx),
                            spacing=layout.mesh.spacing,
                            deformed=layout.mesh.deformed)
        # use the GLOBAL geometry for this slab: cells d*ncz_loc .. (d+1)*ncz_loc
        sl_layout = DofLayout(slab_mesh, degree)
        op = laplace_structured.make_structured_operator(sl_layout, dtype=dtype)
        ops.append(replace_coeffs_structured(op, layout, d, ncz_loc, mask_lat,
                                             Pp, dtype))

    op_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *ops)

    sharding = NamedSharding(mesh, P(AXIS))
    dist = DistributedBP4(
        op_stack=jax.device_put(op_stack, sharding),
        inv_diag=jax.device_put(jnp.asarray(slab(inv_lat), dtype=dtype), sharding),
        b=jax.device_put(jnp.asarray(slab(b_lat), dtype=dtype), sharding),
        weight=jax.device_put(jnp.asarray(weight, dtype=dtype), sharding),
        n_dofs=layout.n_nodes * n_components,
        n_cells=layout.mesh.n_cells,
        n_devices=D,
        ncz_global=ncz,
    )
    return dist, mesh


def dist_matvec_jit(dist: DistributedBP4, mesh: Mesh,
                    constrained_identity: bool = True,
                    overlap: bool = False):
    """Jitted distributed matvec ``u -> A u`` on sharded slab vectors.

    Used by the benchmark harness to time the distributed operator with the
    same 50-matvec protocol as the single-device path (``benchmark.h:
    204-215``).
    """
    n_dev = dist.n_devices

    def body(op_stack, u):
        op_local = _index0(op_stack)
        return dist_vmult(op_local, u[0], n_dev=n_dev,
                          constrained_identity=constrained_identity,
                          overlap=overlap)[None]

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
                       out_specs=P(AXIS), check_vma=False)
    return jax.jit(fn)


def _slab_mask(mask_lat: np.ndarray, d: int, Pp: int) -> np.ndarray:
    """Padded mask slice for slab d: planes past the global top are 0."""
    return _pad_slice(mask_lat, 1, d * Pp, Pp + 1)


def replace_coeffs_structured(op, layout, d, ncz_loc, mask_lat, Pp, dtype):
    from mf_data_locality.ops.geometry import trilinear_coefficients

    ncz, ncy, ncx = layout.mesh.n_cells_axis
    co = trilinear_coefficients(layout.mesh.cell_vertices)
    co = co.reshape(ncz, ncy, ncx, 8, 3)[d * ncz_loc:(d + 1) * ncz_loc]
    short = ncz_loc - co.shape[0]
    if short:  # trailing slab: unit-geometry dummy z-layers
        pad = np.zeros((short, ncy, ncx, 8, 3))
        pad[..., 1, 0] = pad[..., 2, 1] = pad[..., 4, 2] = 1.0
        co = np.concatenate([co, pad], axis=0)
    co = co.reshape(ncz_loc, 1, ncy, 1, ncx, 1, 8, 3)
    mask = _slab_mask(mask_lat, d, Pp)
    return op._replace(coeffs=jnp.asarray(co, dtype=dtype),
                       mask=jnp.asarray(mask, dtype=dtype))


def _halo_sum_axis(v: jax.Array, n_dev: int, axis_name: str,
                   axis: int) -> jax.Array:
    """Complete shared-plane partial sums along one sharded lattice axis.

    Two one-plane ppermutes — the analog of the deal.II partitioner's
    compress(add) + update_ghost_values pair.  With multiple
    sharded axes, applying this per axis in sequence resolves edge/corner
    contributions implicitly (dimension-split halo exchange: the z-sum runs
    over arrays that still carry the y ghosts, so the subsequent y-sum sees
    z-complete planes).
    """
    if n_dev == 1:
        return v
    first = lambda a: jax.lax.slice_in_dim(a, 0, 1, axis=axis)  # noqa: E731
    last = lambda a: jax.lax.slice_in_dim(  # noqa: E731
        a, a.shape[axis] - 1, a.shape[axis], axis=axis)
    rest = lambda a: jax.lax.slice_in_dim(  # noqa: E731
        a, 1, a.shape[axis], axis=axis)
    # 1) send bottom partial down: device d receives plane-0 partial of d+1
    down = [(d, d - 1) for d in range(1, n_dev)]
    recv = jax.lax.ppermute(first(v), axis_name, down)  # zeros on last dev
    upd = last(v) + recv
    v = jnp.concatenate(
        [jax.lax.slice_in_dim(v, 0, v.shape[axis] - 1, axis=axis), upd],
        axis=axis)
    # 2) completed top plane travels up to replace the stale bottom plane
    up = [(d, d + 1) for d in range(n_dev - 1)]
    recv = jax.lax.ppermute(last(v), axis_name, up)  # zeros on device 0
    idx = jax.lax.axis_index(axis_name)
    bottom = jnp.where(idx > 0, recv, first(v))
    return jnp.concatenate([bottom, rest(v)], axis=axis)


def _halo_sum(v: jax.Array, n_dev: int) -> jax.Array:
    """1D z-slab halo sum (axis 1 of the local (C, P+1, Ny, Nx) slab)."""
    return _halo_sum_axis(v, n_dev, AXIS, 1)


def _sub_op(op_local, c0: int, c1: int):
    """Operator data restricted to the z-cell-layer range [c0, c1) of the slab.

    Used by the overlapped apply; only the geometry changes — the 1D
    matrices are shared.  c0/c1 are Python ints, so shapes stay static.
    """
    return op_local._replace(coeffs=op_local.coeffs[c0:c1])


def dist_vmult(op_local, u: jax.Array, n_dev: int,
               constrained_identity: bool = True,
               overlap: bool = False) -> jax.Array:
    """Distributed operator apply on one device's slab (inside shard_map):
    masked local apply, halo sum, mask again (global Dirichlet).

    ``overlap=True`` computes the boundary cell layers first and launches the
    compress ppermute before the interior apply — the analog of the
    reference's before/after-ghost cell partitions inside ``cell_loop``
    (``poisson_operator.h:310,339``; SURVEY.md §2 parallelism item 3).  XLA's
    async collectives can then hide the transfer behind interior compute.
    """
    mask = op_local.mask
    um = u * mask
    p = op_local.values.shape[1] - 1
    Pp = um.shape[1] - 1  # owned planes per slab
    ncz_loc = Pp // p

    if not overlap or n_dev == 1 or ncz_loc < 3:
        raw = _halo_sum(apply_lattice(op_local, um), n_dev)
    else:
        v_bot = apply_lattice(_sub_op(op_local, 0, 1), um[:, :p + 1])
        v_top = apply_lattice(_sub_op(op_local, ncz_loc - 1, ncz_loc),
                              um[:, Pp - p:])
        # compress transfer starts now; interior compute proceeds concurrently
        down = [(d, d - 1) for d in range(1, n_dev)]
        recv_bot = jax.lax.ppermute(v_bot[:, :1], AXIS, down)

        v_int = apply_lattice(_sub_op(op_local, 1, ncz_loc - 1),
                              um[:, p:Pp - p + 1])

        raw = jnp.zeros_like(um)
        raw = jax.lax.dynamic_update_slice_in_dim(raw, v_bot, 0, axis=1)
        raw = raw.at[:, p:Pp - p + 1].add(v_int)
        raw = raw.at[:, Pp - p:].add(v_top)
        raw = raw.at[:, -1:].add(recv_bot)
        up = [(d, d + 1) for d in range(n_dev - 1)]
        recv_top = jax.lax.ppermute(raw[:, -1:], AXIS, up)
        idx = jax.lax.axis_index(AXIS)
        bottom = jnp.where(idx > 0, recv_top, raw[:, :1])
        raw = jnp.concatenate([bottom, raw[:, 1:]], axis=1)

    v = raw * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v


def _index0(tree):
    return jax.tree.map(lambda x: x[0], tree)


def solve(dist: DistributedBP4, mesh: Mesh, solver: str = "merged",
          max_iter: int = 100, rel_tol: float = 1e-8,
          overlap: bool = False) -> cg.SolveResult:
    """Full distributed CG solve; one shard_map region, loop on device.

    The merged variant performs exactly ONE collective per iteration (the
    7-scalar psum) besides the two halo ppermutes inside the operator —
    matching the reference's single ``MPI_Allreduce`` design
    (``poisson_operator.h:373-375``).
    """
    n_dev = dist.n_devices

    def body(op_stack, inv_diag, b, weight):
        op_local = _index0(op_stack)
        prec = inv_diag[0]
        b_loc = b[0]
        w = weight[0]
        a = partial(dist_vmult, op_local, n_dev=n_dev,
                    constrained_identity=(solver == "baseline"),
                    overlap=overlap)
        if solver == "merged":
            res = cg_merged.merged_cg_solve(
                a, b_loc, prec, max_iter=max_iter, rel_tol=rel_tol,
                reduce_sums=lambda s: jax.lax.psum(s, AXIS),
                dot_weight=w)
        else:
            res = cg.cg_solve(
                a, b_loc, prec, max_iter=max_iter, rel_tol=rel_tol,
                reduce_scalar=lambda s: jax.lax.psum(s, AXIS),
                dot_weight=w)
        return (res.x[None], res.n_iterations, res.res_norm, res.res_history,
                res.converged)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(), P(), P(), P()),
        check_vma=False,
    )
    x, it, res_norm, hist, conv = jax.jit(fn)(
        dist.op_stack, dist.inv_diag, dist.b, dist.weight)
    return cg.SolveResult(x, it, res_norm, hist, conv)


AXIS_Y = "y"


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DistributedBP4_2D:
    """2D (z x y) slab decomposition; leading axes (Dz, Dy) sharded."""

    op_stack: Any  # operator pytree, each leaf (Dz, Dy, ...)
    inv_diag: jax.Array  # (Dz, Dy, 1, Pz+1, Py+1, Nx)
    b: jax.Array  # (Dz, Dy, C, Pz+1, Py+1, Nx)
    weight: jax.Array  # (Dz, Dy, 1, Pz+1, Py+1, 1)
    n_dofs: int = field(metadata=dict(static=True), default=0)
    n_cells: int = field(metadata=dict(static=True), default=0)
    mesh_shape: tuple = field(metadata=dict(static=True), default=(1, 1))
    nc_global: tuple = field(metadata=dict(static=True), default=(0, 0, 0))


def _pad_slice(arr: np.ndarray, axis: int, start: int, length: int
               ) -> np.ndarray:
    """arr[start:start+length] along axis, zero-padded past the end."""
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(start, start + length)
    out = arr[tuple(sl)]
    short = length - out.shape[axis]
    if short:
        shape = list(out.shape)
        shape[axis] = short
        out = np.concatenate([out, np.zeros(shape, out.dtype)], axis=axis)
    return out


def _pad_dummy_cells(co: np.ndarray, target_axes: tuple[int, int, int]
                     ) -> np.ndarray:
    """Pad a (ncz', ncy', ncx', 8, 3) coefficient block to the target cell
    counts with unit-geometry dummy cells (poisson_operator.h:269-280)."""
    for ax in range(3):
        short = target_axes[ax] - co.shape[ax]
        if short:
            shape = list(co.shape)
            shape[ax] = short
            pad = np.zeros(shape)
            pad[..., 1, 0] = pad[..., 2, 1] = pad[..., 4, 2] = 1.0
            co = np.concatenate([co, pad], axis=ax)
    return co


def build_distributed_2d(s: int, degree: int, mesh_shape: tuple[int, int],
                         dtype=jnp.float32, n_components: int = 3,
                         devices=None, box: BoxMesh | None = None
                         ) -> tuple[DistributedBP4_2D, Mesh]:
    """Partition BP4 over a 2D (z, y) device mesh.

    The 2D analog of :func:`build_distributed` — each device owns a
    (ncz_loc, ncy_loc, ncx) cell block with replicated shared planes on the
    z and y faces; edge (corner-line) consistency is handled implicitly by
    the sequential per-axis halo sums (SURVEY.md §5 long-context slot;
    ROADMAP "2D/3D device decomposition").
    """
    Dz, Dy = mesh_shape
    devs = list(devices if devices is not None else jax.devices())
    if len(devs) < Dz * Dy:
        raise ValueError(f"requested {Dz}x{Dy} devices, have {len(devs)}")
    mesh = Mesh(np.array(devs[:Dz * Dy]).reshape(Dz, Dy), (AXIS, AXIS_Y))

    layout = DofLayout(box if box is not None else BoxMesh.from_s(s), degree)
    ncz, ncy, ncx = layout.mesh.n_cells_axis
    p = degree
    nz, nyn, nx = layout.n_nodes_axis
    ncz_loc = -(-ncz // Dz)
    ncy_loc = -(-ncy // Dy)
    Pz, Py = ncz_loc * p, ncy_loc * p

    n = layout.n_nodes
    dof_index = (np.arange(n)[:, None] * n_components
                 + np.arange(n_components)[None, :])
    b = (dof_index % 8).astype(np.float64)
    b[layout.boundary_node_mask] = 0.0
    b_lat = b.T.reshape(n_components, nz, nyn, nx)
    inv_diag = np.asarray(
        diagonal.compute_inverse_diagonal(layout, dtype=jnp.float64))
    inv_lat = inv_diag.reshape(1, nz, nyn, nx)
    mask_lat = (~layout.boundary_node_mask).reshape(1, nz, nyn, nx)

    def slab2(arr):
        rows = []
        for dz in range(Dz):
            row = []
            for dy in range(Dy):
                sl = _pad_slice(arr, 1, dz * Pz, Pz + 1)
                sl = _pad_slice(sl, 2, dy * Py, Py + 1)
                row.append(sl)
            rows.append(np.stack(row))
        return np.stack(rows)  # (Dz, Dy, C, Pz+1, Py+1, Nx)

    weight = np.ones((Dz, Dy, 1, Pz + 1, Py + 1, 1))
    weight[1:, :, :, 0] = 0.0  # z-ghost plane of dz > 0
    weight[:, 1:, :, :, 0] = 0.0  # y-ghost plane of dy > 0
    for dz in range(Dz):
        for j in range(Pz + 1):
            if dz * Pz + j >= nz:
                weight[dz, :, :, j] = 0.0
    for dy in range(Dy):
        for k in range(Py + 1):
            if dy * Py + k >= nyn:
                weight[:, dy, :, :, k] = 0.0

    from mf_data_locality.ops.geometry import trilinear_coefficients

    co_all = trilinear_coefficients(layout.mesh.cell_vertices)
    co_all = co_all.reshape(ncz, ncy, ncx, 8, 3)

    ops = []
    for dz in range(Dz):
        row = []
        for dy in range(Dy):
            slab_mesh = BoxMesh(n_cells_axis=(ncz_loc, ncy_loc, ncx),
                                spacing=layout.mesh.spacing,
                                deformed=layout.mesh.deformed)
            sl_layout = DofLayout(slab_mesh, degree)
            co = co_all[dz * ncz_loc:(dz + 1) * ncz_loc,
                        dy * ncy_loc:(dy + 1) * ncy_loc]
            # pad short z/y cell axes with unit-geometry dummies BEFORE
            # flattening — a short y axis would otherwise misalign every
            # z-layer's cell geometry in the flattened kernel layout
            co = _pad_dummy_cells(co, (ncz_loc, ncy_loc, ncx))
            msk = _pad_slice(_pad_slice(mask_lat, 1, dz * Pz, Pz + 1),
                             2, dy * Py, Py + 1)
            op = laplace_structured.make_structured_operator(
                sl_layout, dtype=dtype)
            co = co.reshape(ncz_loc, 1, ncy_loc, 1, ncx, 1, 8, 3)
            row.append(op._replace(coeffs=jnp.asarray(co, dtype=dtype),
                                   mask=jnp.asarray(msk, dtype=dtype)))
        ops.append(jax.tree.map(lambda *xs: jnp.stack(xs), *row))
    op_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *ops)

    sharding = NamedSharding(mesh, P(AXIS, AXIS_Y))
    dist = DistributedBP4_2D(
        op_stack=jax.device_put(op_stack, sharding),
        inv_diag=jax.device_put(jnp.asarray(slab2(inv_lat), dtype=dtype),
                                sharding),
        b=jax.device_put(jnp.asarray(slab2(b_lat), dtype=dtype), sharding),
        weight=jax.device_put(jnp.asarray(weight, dtype=dtype), sharding),
        n_dofs=layout.n_nodes * n_components,
        n_cells=layout.mesh.n_cells,
        mesh_shape=(Dz, Dy),
        nc_global=(ncz, ncy, ncx),
    )
    return dist, mesh


def dist_vmult_2d(op_local, u: jax.Array, mesh_shape,
                  constrained_identity: bool = True) -> jax.Array:
    """Distributed apply on one device's (z, y) block (inside shard_map)."""
    Dz, Dy = mesh_shape
    mask = op_local.mask
    um = u * mask
    raw = apply_lattice(op_local, um)
    raw = _halo_sum_axis(raw, Dz, AXIS, 1)
    raw = _halo_sum_axis(raw, Dy, AXIS_Y, 2)
    v = raw * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v


def solve_2d(dist: DistributedBP4_2D, mesh: Mesh, solver: str = "merged",
             max_iter: int = 100, rel_tol: float = 1e-8) -> cg.SolveResult:
    """Distributed CG over the 2D mesh; one 7-scalar psum over BOTH axes
    per merged iteration."""
    mesh_shape = dist.mesh_shape

    def body(op_stack, inv_diag, b, weight):
        op_local = jax.tree.map(lambda x: x[0, 0], op_stack)
        prec = inv_diag[0, 0]
        b_loc = b[0, 0]
        w = weight[0, 0]
        a = partial(dist_vmult_2d, op_local, mesh_shape=mesh_shape,
                    constrained_identity=(solver == "baseline"))
        psum2 = lambda s: jax.lax.psum(s, (AXIS, AXIS_Y))  # noqa: E731
        if solver == "merged":
            res = cg_merged.merged_cg_solve(
                a, b_loc, prec, max_iter=max_iter, rel_tol=rel_tol,
                reduce_sums=psum2, dot_weight=w)
        else:
            res = cg.cg_solve(
                a, b_loc, prec, max_iter=max_iter, rel_tol=rel_tol,
                reduce_scalar=psum2, dot_weight=w)
        return (res.x[None, None], res.n_iterations, res.res_norm,
                res.res_history, res.converged)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS, AXIS_Y),) * 4,
        out_specs=(P(AXIS, AXIS_Y), P(), P(), P(), P()),
        check_vma=False,
    )
    x, it, res_norm, hist, conv = jax.jit(fn)(
        dist.op_stack, dist.inv_diag, dist.b, dist.weight)
    return cg.SolveResult(x, it, res_norm, hist, conv)


AXIS_X = "x"


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DistributedBP4_3D:
    """Full 3D (z x y x x) slab decomposition; leading axes sharded."""

    op_stack: Any  # operator pytree, each leaf (Dz, Dy, Dx, ...)
    inv_diag: jax.Array
    b: jax.Array  # (Dz, Dy, Dx, C, Pz+1, Py+1, Px+1)
    weight: jax.Array
    n_dofs: int = field(metadata=dict(static=True), default=0)
    n_cells: int = field(metadata=dict(static=True), default=0)
    mesh_shape: tuple = field(metadata=dict(static=True), default=(1, 1, 1))
    nc_global: tuple = field(metadata=dict(static=True), default=(0, 0, 0))


def build_distributed_3d(s: int, degree: int,
                         mesh_shape: tuple[int, int, int],
                         dtype=jnp.float32, n_components: int = 3,
                         devices=None, box: BoxMesh | None = None
                         ) -> tuple[DistributedBP4_3D, Mesh]:
    """Partition BP4 over a full 3D device mesh (all three lattice axes).

    Halo consistency is three sequential per-axis plane exchanges —
    dimension-split, so edges AND corners resolve implicitly.
    """
    Dz, Dy, Dx = mesh_shape
    devs = list(devices if devices is not None else jax.devices())
    if len(devs) < Dz * Dy * Dx:
        raise ValueError(f"requested {Dz}x{Dy}x{Dx} devices, have {len(devs)}")
    mesh = Mesh(np.array(devs[:Dz * Dy * Dx]).reshape(Dz, Dy, Dx),
                (AXIS, AXIS_Y, AXIS_X))

    layout = DofLayout(box if box is not None else BoxMesh.from_s(s), degree)
    ncz, ncy, ncx = layout.mesh.n_cells_axis
    p = degree
    nz, nyn, nx = layout.n_nodes_axis
    loc = [-(-n // D) for n, D in ((ncz, Dz), (ncy, Dy), (ncx, Dx))]
    Pz, Py, Px = (c * p for c in loc)

    n = layout.n_nodes
    dof_index = (np.arange(n)[:, None] * n_components
                 + np.arange(n_components)[None, :])
    b = (dof_index % 8).astype(np.float64)
    b[layout.boundary_node_mask] = 0.0
    b_lat = b.T.reshape(n_components, nz, nyn, nx)
    inv_lat = np.asarray(diagonal.compute_inverse_diagonal(
        layout, dtype=jnp.float64)).reshape(1, nz, nyn, nx)
    mask_lat = (~layout.boundary_node_mask).reshape(1, nz, nyn, nx)

    def slab3(arr):
        blocks = np.empty((Dz, Dy, Dx), dtype=object)
        for dz in range(Dz):
            for dy in range(Dy):
                for dx in range(Dx):
                    sl = _pad_slice(arr, 1, dz * Pz, Pz + 1)
                    sl = _pad_slice(sl, 2, dy * Py, Py + 1)
                    sl = _pad_slice(sl, 3, dx * Px, Px + 1)
                    blocks[dz, dy, dx] = sl
        return np.stack([np.stack([np.stack(list(blocks[z_, y_]))
                                   for y_ in range(Dy)])
                         for z_ in range(Dz)])

    weight = np.ones((Dz, Dy, Dx, 1, Pz + 1, Py + 1, Px + 1))
    weight[1:, :, :, :, 0] = 0.0
    weight[:, 1:, :, :, :, 0] = 0.0
    weight[:, :, 1:, :, :, :, 0] = 0.0
    for dz in range(Dz):
        for j in range(Pz + 1):
            if dz * Pz + j >= nz:
                weight[dz, :, :, :, j] = 0.0
    for dy in range(Dy):
        for k in range(Py + 1):
            if dy * Py + k >= nyn:
                weight[:, dy, :, :, :, k] = 0.0
    for dx in range(Dx):
        for l_ in range(Px + 1):
            if dx * Px + l_ >= nx:
                weight[:, :, dx, :, :, :, l_] = 0.0

    from mf_data_locality.ops.geometry import trilinear_coefficients

    co_all = trilinear_coefficients(layout.mesh.cell_vertices)
    co_all = co_all.reshape(ncz, ncy, ncx, 8, 3)

    def one_op(dz, dy, dx):
        slab_mesh = BoxMesh(n_cells_axis=tuple(loc),
                            spacing=layout.mesh.spacing,
                            deformed=layout.mesh.deformed)
        sl_layout = DofLayout(slab_mesh, degree)
        co = co_all[dz * loc[0]:(dz + 1) * loc[0],
                    dy * loc[1]:(dy + 1) * loc[1],
                    dx * loc[2]:(dx + 1) * loc[2]]
        msk = _pad_slice(_pad_slice(_pad_slice(
            mask_lat, 1, dz * Pz, Pz + 1), 2, dy * Py, Py + 1),
            3, dx * Px, Px + 1)
        co = _pad_dummy_cells(co, tuple(loc))
        op = laplace_structured.make_structured_operator(sl_layout,
                                                         dtype=dtype)
        co = co.reshape(loc[0], 1, loc[1], 1, loc[2], 1, 8, 3)
        return op._replace(coeffs=jnp.asarray(co, dtype=dtype),
                           mask=jnp.asarray(msk, dtype=dtype))

    zrows = []
    for dz in range(Dz):
        yrows = []
        for dy in range(Dy):
            ops = [one_op(dz, dy, dx) for dx in range(Dx)]
            yrows.append(jax.tree.map(lambda *xs: jnp.stack(xs), *ops))
        zrows.append(jax.tree.map(lambda *xs: jnp.stack(xs), *yrows))
    op_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *zrows)

    sharding = NamedSharding(mesh, P(AXIS, AXIS_Y, AXIS_X))
    dist = DistributedBP4_3D(
        op_stack=jax.device_put(op_stack, sharding),
        inv_diag=jax.device_put(jnp.asarray(slab3(inv_lat), dtype=dtype),
                                sharding),
        b=jax.device_put(jnp.asarray(slab3(b_lat), dtype=dtype), sharding),
        weight=jax.device_put(jnp.asarray(weight, dtype=dtype), sharding),
        n_dofs=layout.n_nodes * n_components,
        n_cells=layout.mesh.n_cells,
        mesh_shape=(Dz, Dy, Dx),
        nc_global=(ncz, ncy, ncx),
    )
    return dist, mesh


def solve_3d(dist: DistributedBP4_3D, mesh: Mesh, solver: str = "merged",
             max_iter: int = 100, rel_tol: float = 1e-8) -> cg.SolveResult:
    """Distributed CG over the 3D mesh: three per-axis halo exchanges per
    apply, one 7-scalar psum over all three axes per merged iteration."""
    Dz, Dy, Dx = dist.mesh_shape

    def a_fn(op_local, u):
        mask = op_local.mask
        um = u * mask
        raw = apply_lattice(op_local, um)
        raw = _halo_sum_axis(raw, Dz, AXIS, 1)
        raw = _halo_sum_axis(raw, Dy, AXIS_Y, 2)
        raw = _halo_sum_axis(raw, Dx, AXIS_X, 3)
        v = raw * mask
        if solver == "baseline":
            v = v + u * (1.0 - mask)
        return v

    def body(op_stack, inv_diag, b, weight):
        op_local = jax.tree.map(lambda x: x[0, 0, 0], op_stack)
        psum3 = lambda v: jax.lax.psum(v, (AXIS, AXIS_Y, AXIS_X))  # noqa: E731
        a = partial(a_fn, op_local)
        if solver == "merged":
            res = cg_merged.merged_cg_solve(
                a, b[0, 0, 0], inv_diag[0, 0, 0], max_iter=max_iter,
                rel_tol=rel_tol, reduce_sums=psum3, dot_weight=weight[0, 0, 0])
        else:
            res = cg.cg_solve(
                a, b[0, 0, 0], inv_diag[0, 0, 0], max_iter=max_iter,
                rel_tol=rel_tol, reduce_scalar=psum3,
                dot_weight=weight[0, 0, 0])
        return (res.x[None, None, None], res.n_iterations, res.res_norm,
                res.res_history, res.converged)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS, AXIS_Y, AXIS_X),) * 4,
        out_specs=(P(AXIS, AXIS_Y, AXIS_X), P(), P(), P(), P()),
        check_vma=False,
    )
    x, it, res_norm, hist, conv = jax.jit(fn)(
        dist.op_stack, dist.inv_diag, dist.b, dist.weight)
    return cg.SolveResult(x, it, res_norm, hist, conv)


def gather_global_3d(x_dist: jax.Array, nz: int | None = None,
                     ny: int | None = None,
                     nx: int | None = None) -> np.ndarray:
    """(Dz, Dy, Dx, C, Pz+1, Py+1, Px+1) -> global (C, Nz, Ny, Nx)."""
    x = np.asarray(x_dist)
    Dz, Dy, Dx = x.shape[:3]
    zparts = []
    for dz in range(Dz):
        yparts = []
        for dy in range(Dy):
            xparts = [x[dz, dy, 0]] + [x[dz, dy, dx][..., 1:]
                                       for dx in range(1, Dx)]
            row = np.concatenate(xparts, axis=3)
            yparts.append(row if dy == 0 else row[:, :, 1:])
        yrow = np.concatenate(yparts, axis=2)
        zparts.append(yrow if dz == 0 else yrow[:, 1:])
    full = np.concatenate(zparts, axis=1)
    if nz is not None:
        full = full[:, :nz]
    if ny is not None:
        full = full[:, :, :ny]
    if nx is not None:
        full = full[:, :, :, :nx]
    return full


def gather_global_2d(x_dist: jax.Array, nz: int | None = None,
                     ny: int | None = None) -> np.ndarray:
    """(Dz, Dy, C, Pz+1, Py+1, Nx) -> global (C, Nz, Ny, Nx)."""
    x = np.asarray(x_dist)
    Dz, Dy = x.shape[:2]
    rows = []
    for dz in range(Dz):
        cols = [x[dz, 0]] + [x[dz, dy][:, :, 1:] for dy in range(1, Dy)]
        row = np.concatenate(cols, axis=2)
        rows.append(row if dz == 0 else row[:, 1:])
    full = np.concatenate(rows, axis=1)
    if nz is not None:
        full = full[:, :nz]
    if ny is not None:
        full = full[:, :, :ny]
    return full


def gather_global(x_dist: jax.Array, nz: int | None = None) -> np.ndarray:
    """(D, C, P+1, Ny, Nx) distributed vector -> global (C, Nz, Ny, Nx).

    ``nz`` trims trailing dummy planes when the device count does not divide
    the z-cell count; omit it for exactly-tiling partitions.
    """
    x = np.asarray(x_dist)
    D = x.shape[0]
    parts = [x[0]] + [x[d][:, 1:] for d in range(1, D)]
    full = np.concatenate(parts, axis=1)
    return full if nz is None else full[:, :nz]
