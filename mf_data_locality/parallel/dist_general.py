"""Distributed GENERAL (gather/scatter) backend: cell-chunk decomposition.

The reference decomposes *arbitrary* p4est meshes over MPI ranks
(``common_code/benchmark.h:79``) and relies on the renumbering's rank-set
grouping so each rank's halo data is a few contiguous index ranges
(``renumber_dofs_for_mf.h:492-535, 673-730``).  This module is the JAX
analog for the general gather-map backend (:mod:`~mf_data_locality.ops.
laplace`) — the "any hex mesh as gather maps" story, distributed:

* **Partition**: cells are split into contiguous chunks in sweep order
  (the p4est space-filling-curve partition analog).  Node ownership is
  first-touch: the lowest rank whose cells touch a node owns it
  (``domain_dof_mapping``, :673-730).
* **Per-rank local numbering**: each rank numbers its local nodes with
  :func:`mf_data_locality.mesh.renumber.locality_permutation` under
  REAL ghost flags — interior (touched once) first in sweep order, then
  rank-internal shared nodes, then ghosts last (grouping strategy 2,
  :492-535) — followed by a rank-set pass: export nodes (owned nodes read
  by higher ranks) move to the end of the owned block, and the ghost
  block is sorted by (owner-rank offset, global id).  Each rank's import
  halo is then a **contiguous trailing slice, itself split into one
  contiguous sub-slice per owner rank** — the exact property the
  reference's grouping buys for the partitioner's import_indices (fewer,
  larger messages).
* **Ghost exchange**: one ``ppermute`` pair per rank-offset present in the
  decomposition (a z-slab cut has only offset 1; thinner chunks produce
  offsets {1, 2, ...}, the analog of a p4est partition's multi-rank
  neighborhoods): ghost partial sums travel to the owner (compress/add),
  completed owner values travel back (update_ghost_values) — the pair
  hidden inside ``MatrixFree::cell_loop`` in the reference
  (``poisson_operator.h:310,339``).  Send/recv order matches because both
  ends sort each (owner, reader) interface set by global id.
* **Dots**: zero weight on ghost and padding nodes so every global DoF
  counts once; the merged CG then needs exactly ONE ``psum`` of 7 scalars
  per iteration (``poisson_operator.h:373-375``).

Ranks hold identically-shaped arrays (SPMD static shapes): node counts,
cell counts, scatter multiplicities and halo widths are padded to the
per-mesh maxima with a dead node (zero mask/weight) and replicated-geometry
dummy cells whose gather points at the dead node (the reference's
dummy-lane fill, ``poisson_operator.h:269-280``).
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
from mf_data_locality.mesh import renumber as rn
from mf_data_locality.ops import diagonal, geometry, lagrange, laplace
from mf_data_locality.solvers import cg, cg_merged

AXIS = "z"


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DistributedGeneral:
    """Per-device stacked general-backend problem; leading axis D sharded."""

    op_stack: Any  # laplace.LaplaceOperatorData, each leaf (D, ...)
    inv_diag: jax.Array  # (D, 1, NL)
    b: jax.Array  # (D, C, NL)
    weight: jax.Array  # (D, 1, NL): 1 owned real nodes, 0 ghosts/padding
    export_idx: jax.Array  # (D, n_offsets, E): local ids read by rank d+off
    import_idx: jax.Array  # (D, n_offsets, E): ghost ids owned by rank d-off
    n_dofs: int = field(metadata=dict(static=True), default=0)
    n_cells: int = field(metadata=dict(static=True), default=0)
    n_devices: int = field(metadata=dict(static=True), default=1)
    offsets: tuple = field(metadata=dict(static=True), default=(1,))
    """Distinct owner→reader rank distances present in the decomposition."""


def _partition_cells(n_cells: int, n_dev: int) -> list[np.ndarray]:
    """Contiguous sweep-order cell chunks, ceil-sized (benchmark.h:79)."""
    cpr = -(-n_cells // n_dev)
    return [np.arange(r * cpr, min((r + 1) * cpr, n_cells))
            for r in range(n_dev)]


def _decompose(layout: DofLayout, D: int) -> tuple[list[dict], tuple[int, ...]]:
    """Host-side rank decomposition: per-rank local numbering + halo sets.

    Returns one dict per rank with the locality-renumbered local gather map
    and the per-offset export/import node sets (new-local ids, canonical
    global-id order), plus the tuple of rank offsets present anywhere.
    """
    gather = np.asarray(layout.gather_map)
    n_cells, nloc = gather.shape
    n = layout.n_nodes
    if D > n_cells:
        raise ValueError(f"{D} devices > {n_cells} cells")
    chunks = _partition_cells(n_cells, D)

    cell_rank = np.empty(n_cells, np.int64)
    for r, ch in enumerate(chunks):
        cell_rank[ch] = r
    rank_of_slot = np.repeat(cell_rank, nloc)
    flat = gather.reshape(-1).astype(np.int64)
    # first-touch ownership (domain_dof_mapping, renumber_dofs_for_mf.h:673-730)
    owner = np.full(n, D, np.int64)
    np.minimum.at(owner, flat, rank_of_slot)
    # the full (node, touching-rank) relation — the reference's rank sets
    pairs = np.unique(flat * D + rank_of_slot)
    pair_node, pair_rank = pairs // D, pairs % D
    reader = pair_rank != owner[pair_node]  # touches but does not own
    offsets = tuple(sorted(np.unique(
        (pair_rank - owner[pair_node])[reader]).tolist()))

    per_rank = []
    for r, ch in enumerate(chunks):
        gids = np.unique(gather[ch].reshape(-1))
        g2l = np.full(n, -1, np.int64)
        g2l[gids] = np.arange(gids.size)
        gather_r = g2l[gather[ch]].astype(np.int32)
        ghost_flags = owner[gids] != r
        # locality renumbering with REAL ghost flags: interior → shared →
        # ghosts-last (strategy triple (0, 1, 2), :492-535)
        base_perm, _ = rn.locality_permutation(gather_r, gids.size,
                                               ghost_flags=ghost_flags)
        # rank-set pass: exports to the end of the owned block (by gid),
        # ghosts sorted by (owner offset, gid) → per-owner contiguous slices
        exported = np.zeros(n, bool)
        exported[pair_node[reader & (owner[pair_node] == r)]] = True
        export_flags = (~ghost_flags) & exported[gids]
        cls = np.where(ghost_flags, 2, np.where(export_flags, 1, 0))
        delta = np.where(ghost_flags, r - owner[gids], 0)
        within = np.where(cls == 0, base_perm.astype(np.int64),
                          delta * n + gids)
        order = np.lexsort((within, cls))
        perm = np.empty(gids.size, np.int32)
        perm[order] = np.arange(gids.size, dtype=np.int32)

        exports, imports = {}, {}
        for off in offsets:
            is_reader = (pair_rank == r + off) & (owner[pair_node] == r)
            eg = np.intersect1d(pair_node[is_reader], gids)
            exports[off] = perm[g2l[eg]]  # gid-sorted already (intersect1d)
            ig = gids[ghost_flags & (owner[gids] == r - off)]
            imports[off] = perm[g2l[np.sort(ig)]]
        per_rank.append(dict(
            cells=ch, gids=gids, n_local=gids.size,
            gather=rn.apply_permutation(gather_r, perm),
            order=np.argsort(perm),  # new-local -> old-local
            exports=exports, imports=imports, owner_mask=~ghost_flags,
        ))
    return per_rank, offsets


def build_dist_general(s: int, degree: int, n_devices: int | None = None,
                       dtype=jnp.float32, n_components: int = 3,
                       devices=None,
                       layout=None) -> tuple[DistributedGeneral, Mesh]:
    """Partition the BP4 problem over a 1D device mesh, general backend.

    Host-side NumPy setup mirroring the reference's rank-local view: each
    device gets its cell chunk's geometry, a locality-renumbered local gather
    map, the transposed scatter map rebuilt for the local numbering, and
    contiguous halo index slices.

    ``layout``: any DofLayout-compatible object (``mesh.cell_vertices``,
    ``gather_map``, ``boundary_node_mask``) — e.g. an irregular hex mesh
    through :class:`mesh.general.GeneralDofLayout`; ``s`` is ignored then
    (the deal.II-generality slot, ``benchmark.h:67-89``).
    """
    devs = list(devices if devices is not None else jax.devices())
    D = n_devices or len(devs)
    if len(devs) < D:
        raise ValueError(f"requested {D} devices, only {len(devs)} available")
    mesh = Mesh(np.array(devs[:D]), (AXIS,))

    if layout is None:
        layout = DofLayout(BoxMesh.from_s(s), degree)
    per_rank, offsets = _decompose(layout, D)
    n = layout.n_nodes
    nloc = layout.gather_map.shape[1]

    # global problem data (same recipe as bp4.build)
    dof_index = (np.arange(n)[:, None] * n_components
                 + np.arange(n_components)[None, :])
    b_glob = (dof_index % 8).astype(np.float64)
    b_glob[layout.boundary_node_mask] = 0.0
    b_glob = b_glob.T  # (C, n)
    inv_glob = np.asarray(
        diagonal.compute_inverse_diagonal(layout, dtype=jnp.float64))
    uncon_glob = (~layout.boundary_node_mask).astype(np.float64)
    coeffs_glob = geometry.trilinear_coefficients(layout.mesh.cell_vertices)

    q = degree + 2
    shape = lagrange.make_shape(degree, q)
    qz, qy, qx = np.meshgrid(shape.q_points, shape.q_points, shape.q_points,
                             indexing="ij")
    q_uvw = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    w = shape.q_weights
    q_w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).reshape(-1)

    NL = max(pr["n_local"] for pr in per_rank) + 1  # +1 dead node
    NC = max(len(pr["cells"]) for pr in per_rank)
    # D=1 has no rank-offset pairs (offsets=()): zero-width halo arrays,
    # the exchange loops below run zero times
    E = max((pr[k][o].size for pr in per_rank for o in offsets
             for k in ("exports", "imports")), default=0)
    dead = NL - 1

    op_list, invs, bs, weights, exps, imps, kmaxes = [], [], [], [], [], [], []
    for pr in per_rank:
        nl, ncr = pr["n_local"], len(pr["cells"])
        n_ghost = int((~pr["owner_mask"]).sum())
        gl_new = pr["gids"][pr["order"]]  # global id of each new-local id

        gather_pad = np.full((NC, nloc), dead, np.int32)
        gather_pad[:ncr] = pr["gather"]
        co = np.empty((NC, 8, 3))
        co[:ncr] = coeffs_glob[pr["cells"]]
        co[ncr:] = coeffs_glob[pr["cells"][0]]  # replicated real geometry
        uncon = np.zeros(NL)
        uncon[:nl] = uncon_glob[gl_new]
        # scatter map from the REAL cells only: their flat output positions
        # form the prefix of the padded (NC * nloc) flattening, and the dead
        # node must not absorb the dummy cells' (all-zero) contributions —
        # its row stays valid=0 so KMAX remains the mesh multiplicity (8)
        pos, valid = laplace._transposed_scatter_map(pr["gather"], NL)
        kmaxes.append((pos, valid))
        inv_l = np.ones((1, NL))
        inv_l[0, :nl] = inv_glob[gl_new]
        b_l = np.zeros((n_components, NL))
        b_l[:, :nl] = b_glob[:, gl_new]
        wgt = np.zeros((1, NL))
        wgt[0, :nl - n_ghost] = 1.0  # owned real nodes only
        exp_pad = np.full((len(offsets), E), dead, np.int32)
        imp_pad = np.full((len(offsets), E), dead, np.int32)
        for k, off in enumerate(offsets):
            exp_pad[k, :pr["exports"][off].size] = pr["exports"][off]
            imp_pad[k, :pr["imports"][off].size] = pr["imports"][off]
        op_list.append((co, gather_pad, uncon))
        invs.append(inv_l), bs.append(b_l), weights.append(wgt)
        exps.append(exp_pad), imps.append(imp_pad)

    KM = max(pos.shape[1] for pos, _ in kmaxes)
    ops = []
    for (co, gather_pad, uncon), (pos, valid) in zip(op_list, kmaxes):
        if pos.shape[1] < KM:  # pad scatter multiplicity to the mesh max
            pad = KM - pos.shape[1]
            pos = np.pad(pos, ((0, 0), (0, pad)))
            valid = np.pad(valid, ((0, 0), (0, pad)))
        ops.append(laplace.LaplaceOperatorData(
            values=jnp.asarray(shape.values, dtype=dtype),
            d_col=jnp.asarray(shape.d_col, dtype=dtype),
            q_uvw=jnp.asarray(q_uvw, dtype=dtype),
            q_w3=jnp.asarray(q_w3, dtype=dtype),
            coeffs=jnp.asarray(co, dtype=dtype),
            gather=jnp.asarray(gather_pad),
            unconstrained=jnp.asarray(uncon, dtype=dtype),
            scatter_pos=jnp.asarray(pos),
            scatter_valid=jnp.asarray(valid, dtype=dtype),
        ))
    op_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *ops)

    sharding = NamedSharding(mesh, P(AXIS))
    dist = DistributedGeneral(
        op_stack=jax.device_put(op_stack, sharding),
        inv_diag=jax.device_put(jnp.asarray(np.stack(invs), dtype=dtype),
                                sharding),
        b=jax.device_put(jnp.asarray(np.stack(bs), dtype=dtype), sharding),
        weight=jax.device_put(jnp.asarray(np.stack(weights), dtype=dtype),
                              sharding),
        export_idx=jax.device_put(jnp.asarray(np.stack(exps)), sharding),
        import_idx=jax.device_put(jnp.asarray(np.stack(imps)), sharding),
        n_dofs=layout.n_nodes * n_components,
        n_cells=layout.mesh.n_cells,
        n_devices=D,
        offsets=offsets,
    )
    return dist, mesh


def dist_vmult_general(op_local, u: jax.Array, export_idx: jax.Array,
                       import_idx: jax.Array, n_dev: int,
                       offsets: tuple[int, ...],
                       constrained_identity: bool = True) -> jax.Array:
    """Distributed general-backend apply on one rank's local nodes.

    Ghost entries of ``u`` mirror their owner (the replicated-plane invariant
    of :mod:`.distributed`, here as replicated trailing slices); after the
    local gather→apply→scatter, ghost partial sums ride one ``ppermute`` per
    rank offset to the owner (compress/add) and completed values ride one
    back (update_ghost_values) — ``poisson_operator.h:310,339``.  Padded halo
    slots point at the dead node, whose value is identically zero, so they
    exchange zeros.
    """
    mask = op_local.unconstrained[None]
    um = u * mask
    raw = laplace.apply_cells(op_local, um)
    if n_dev > 1:
        idx = jax.lax.axis_index(AXIS)
        for k, off in enumerate(offsets):  # compress: partials -> owner
            down = [(d, d - off) for d in range(off, n_dev)]
            recv = jax.lax.ppermute(raw[:, import_idx[k]], AXIS, down)
            raw = raw.at[:, export_idx[k]].add(recv)
        for k, off in enumerate(offsets):  # update: owner values -> ghosts
            up = [(d, d + off) for d in range(n_dev - off)]
            recv2 = jax.lax.ppermute(raw[:, export_idx[k]], AXIS, up)
            raw = raw.at[:, import_idx[k]].set(
                jnp.where(idx >= off, recv2, raw[:, import_idx[k]]))
    v = raw * mask
    if constrained_identity:
        v = v + u * (1.0 - mask)
    return v


def dist_matvec_jit(dist: DistributedGeneral, mesh: Mesh,
                    constrained_identity: bool = True):
    """Jitted distributed general-backend matvec on sharded local vectors.

    Harness hook for the 50-matvec timing protocol (``benchmark.h:204-215``).
    """
    n_dev, offsets = dist.n_devices, dist.offsets

    def body(op_stack, exp_i, imp_i, u):
        op_local = jax.tree.map(lambda x: x[0], op_stack)
        return dist_vmult_general(op_local, u[0], exp_i[0], imp_i[0],
                                  n_dev=n_dev, offsets=offsets,
                                  constrained_identity=constrained_identity
                                  )[None]

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(AXIS),) * 4,
                       out_specs=P(AXIS), check_vma=False)
    return jax.jit(fn)


def solve_general(dist: DistributedGeneral, mesh: Mesh,
                  solver: str = "merged", max_iter: int = 100,
                  rel_tol: float = 1e-8) -> cg.SolveResult:
    """Distributed CG on the general backend; one shard_map region.

    Merged variant: ONE 7-scalar ``psum`` per iteration plus the halo
    ppermutes inside the operator (``poisson_operator.h:373-375``).
    """
    n_dev = dist.n_devices
    offsets = dist.offsets

    def body(op_stack, inv_diag, b, weight, exp_i, imp_i):
        op_local = jax.tree.map(lambda x: x[0], op_stack)
        a = partial(dist_vmult_general, op_local, export_idx=exp_i[0],
                    import_idx=imp_i[0], n_dev=n_dev, offsets=offsets,
                    constrained_identity=(solver == "baseline"))
        if solver == "merged":
            res = cg_merged.merged_cg_solve(
                a, b[0], inv_diag[0], max_iter=max_iter, rel_tol=rel_tol,
                reduce_sums=lambda sums: jax.lax.psum(sums, AXIS),
                dot_weight=weight[0])
        else:
            res = cg.cg_solve(
                a, b[0], inv_diag[0], max_iter=max_iter, rel_tol=rel_tol,
                reduce_scalar=lambda x: jax.lax.psum(x, AXIS),
                dot_weight=weight[0])
        return (res.x[None], res.n_iterations, res.res_norm,
                res.res_history, res.converged)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS),) * 6,
        out_specs=(P(AXIS), P(), P(), P(), P()),
        check_vma=False,
    )
    x, it, res_norm, hist, conv = jax.jit(fn)(
        dist.op_stack, dist.inv_diag, dist.b, dist.weight,
        dist.export_idx, dist.import_idx)
    return cg.SolveResult(x, it, res_norm, hist, conv)


def gather_global_general(dist: DistributedGeneral, x_dist: jax.Array,
                          s: int, degree: int,
                          n_components: int = 3,
                          layout=None) -> np.ndarray:
    """Reassemble a distributed solution into the global (C, n_nodes) vector."""
    if layout is None:
        layout = DofLayout(BoxMesh.from_s(s), degree)
    per_rank, _ = _decompose(layout, dist.n_devices)
    xd = np.asarray(x_dist)
    out = np.zeros((n_components, layout.n_nodes))
    for r, pr in enumerate(per_rank):
        own_old = pr["owner_mask"]  # old-local boolean
        perm = np.empty(pr["n_local"], np.int64)
        perm[pr["order"]] = np.arange(pr["n_local"])
        out[:, pr["gids"][own_old]] = xd[r][:, perm[own_old]]
    return out
