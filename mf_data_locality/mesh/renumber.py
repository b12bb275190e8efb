"""Data-locality DoF renumbering for general (unstructured-style) meshes.

Capability of ``Renumber<dim, Number>`` (reference:
``common_code/renumber_dofs_for_mf.h:15-145``), whose strategy triple
(0, 1, 2) = (cell_assembly, first_touch, touch-count grouping) the benchmark
uses (``benchmark.h:112``).  The permutation orders scalar nodes so that

1. nodes touched by exactly one cell ("interior", never communicated) come
   first in first-touch sweep order — the matrix-free loop then walks memory
   almost sequentially (``:247-361, 461-474, 556-590``);
2. nodes shared between cells follow, also in first-touch order;
3. ghost nodes (shared with other partitions) come last, so the partitioner's
   import/export ranges are few and contiguous (``:492-535, 673-730``).

On the structured fast path the lattice layout already has this property by
construction (SURVEY.md §7); this module serves the *general* gather/scatter
backend, where gather locality decides how much of each fetched memory
segment is used.  A native C++ implementation is used when available
(:mod:`mf_data_locality.native`), with this NumPy version as the
reference/fallback.
"""

from __future__ import annotations

import numpy as np

from mf_data_locality import native


def locality_permutation_np(gather: np.ndarray, n_nodes: int,
                            ghost_flags: np.ndarray | None = None,
                            touch_order: str = "first",
                            grouping: str = "touch_count",
                            batch_cells: int | None = None,
                            ) -> tuple[np.ndarray, int]:
    """Pure-NumPy locality permutation: returns (perm old->new, n_interior).

    ``touch_order``: "first" (renumber strategy 1, ``first_touch_renumber``
    :461-474) or "last" (strategy 0, ``last_touch_renumber`` :476-490).
    ``grouping``: "touch_count" (grouping strategy 2, :556-590), "none"
    (strategy 0, ``base_grouping`` :537-554 — sweep order only, ghosts last)
    or "touch_count_cellbatch" (``touch_count_cellbatch`` :592-620 — touch
    counts at cell-*batch* granularity: a node shared only within one batch
    still counts as touched-once, since one kernel block resolves it
    locally).

    ``batch_cells`` quantizes the sweep positions to batches of that many
    cells (``cellbatch_assembly`` :363-459): nodes first touched by the same
    kernel cell block tie in sweep order and keep their relative old order.
    The natural batch is a device kernel's cell block (the analog of the
    reference's ``VectorizedArray`` SIMD width).
    """
    flat = gather.reshape(-1)
    nodes_per_cell = gather.shape[-1] if gather.ndim > 1 else 1
    touch = np.bincount(flat, minlength=n_nodes)

    if batch_cells:
        pos = np.arange(flat.size) // (nodes_per_cell * batch_cells)
    else:
        pos = np.arange(flat.size)

    # touch order: first/last batch (or flat position) in the cell sweep
    order_idx = np.full(n_nodes, flat.size, dtype=np.int64)
    if touch_order == "first":
        np.minimum.at(order_idx, flat, pos)
    elif touch_order == "last":
        order_idx[:] = -1
        np.maximum.at(order_idx, flat, pos)
        order_idx[order_idx < 0] = flat.size
    else:
        raise ValueError(touch_order)
    order_rank = np.argsort(np.argsort(order_idx, kind="stable"), kind="stable")

    if ghost_flags is None:
        ghost_flags = np.zeros(n_nodes, dtype=bool)
    if grouping == "touch_count":
        cls = np.where(ghost_flags, 2, np.where(touch == 1, 0, 1))
    elif grouping == "touch_count_cellbatch":
        bc = batch_cells or 1
        batch_of_slot = np.arange(flat.size) // (nodes_per_cell * bc)
        nb = int(batch_of_slot[-1]) + 1 if flat.size else 1
        pairs = np.unique(flat.astype(np.int64) * nb + batch_of_slot)
        touch_b = np.bincount(pairs // nb, minlength=n_nodes)
        cls = np.where(ghost_flags, 2, np.where(touch_b <= 1, 0, 1))
    elif grouping == "none":
        cls = np.where(ghost_flags, 2, 0)
    else:
        raise ValueError(grouping)
    key = cls.astype(np.int64) * (2 * n_nodes + flat.size) + order_rank
    order = np.argsort(key, kind="stable")
    perm = np.empty(n_nodes, dtype=np.int32)
    perm[order] = np.arange(n_nodes, dtype=np.int32)
    n_interior = int(np.count_nonzero((cls == 0) & ~ghost_flags & (touch == 1)))
    return perm, n_interior


def locality_permutation(gather: np.ndarray, n_nodes: int,
                         ghost_flags: np.ndarray | None = None,
                         touch_order: str = "first",
                         grouping: str = "touch_count",
                         batch_cells: int | None = None,
                         ) -> tuple[np.ndarray, int]:
    """Locality permutation; native C++ when available (default strategies
    only — the benchmark triple (0, 1, 2)), NumPy otherwise."""
    if (native.AVAILABLE and touch_order == "first"
            and grouping == "touch_count" and not batch_cells):
        gf = None if ghost_flags is None else ghost_flags.astype(np.uint8)
        return native.renumber_locality(gather, n_nodes, gf)
    return locality_permutation_np(gather, n_nodes, ghost_flags,
                                   touch_order=touch_order, grouping=grouping,
                                   batch_cells=batch_cells)


def apply_permutation(gather: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Renumbered gather map: new node ids at the same cell-local slots."""
    return perm[gather]


def permute_nodes(arr: np.ndarray, perm: np.ndarray, axis: int = -1
                  ) -> np.ndarray:
    """Reorder a per-node array into the new numbering (out[perm[i]] = in[i])."""
    out = np.empty_like(arr)
    idx = [slice(None)] * arr.ndim
    idx[axis] = perm
    out[tuple(idx)] = arr
    return out
