"""Native C++ setup library vs NumPy reference paths, and renumbering."""

import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality import native
from mf_data_locality.mesh import renumber
from mf_data_locality.mesh.box import BoxMesh
from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops.geometry import trilinear_coefficients

needs_native = pytest.mark.skipif(not native.AVAILABLE,
                                  reason="native library not built")


@needs_native
@pytest.mark.parametrize("s,p", [(4, 2), (6, 3), (3, 1)])
def test_native_gather_map_matches_numpy(s, p):
    layout = DofLayout(BoxMesh.from_s(s), p)
    ncz, ncy, ncx = layout.mesh.n_cells_axis
    got = native.gather_map(p, ncz, ncy, ncx)
    np.testing.assert_array_equal(got, layout.gather_map)


@needs_native
@pytest.mark.parametrize("s", [3, 5])
def test_native_vertex_lattice_and_coeffs(s):
    m = BoxMesh.from_s(s)
    ncz, ncy, ncx = m.n_cells_axis
    verts = native.vertex_lattice(ncz, ncy, ncx, m.spacing)
    assert np.abs(verts - m.vertex_lattice).max() < 1e-14
    co = native.trilinear_coefficients(ncz, ncy, ncx, verts)
    expect = trilinear_coefficients(m.cell_vertices)
    assert np.abs(co - expect).max() < 1e-14


@needs_native
def test_native_boundary_mask():
    layout = DofLayout(BoxMesh.from_s(5), 3)
    nz, ny, nx = layout.n_nodes_axis
    got = native.boundary_mask(nz, ny, nx)
    np.testing.assert_array_equal(got, layout.boundary_node_mask)


@needs_native
@pytest.mark.parametrize("s,p", [(4, 2), (3, 3)])
def test_native_renumber_matches_numpy(s, p):
    layout = DofLayout(BoxMesh.from_s(s), p)
    gm = layout.gather_map
    ghost = np.zeros(layout.n_nodes, dtype=bool)
    ghost[-layout.n_nodes // 5:] = True  # pretend a chunk is ghost
    pn, ni_n = renumber.locality_permutation_np(gm, layout.n_nodes, ghost)
    pc, ni_c = native.renumber_locality(gm, layout.n_nodes,
                                        ghost.astype(np.uint8))
    assert ni_n == ni_c
    np.testing.assert_array_equal(pn, pc)


def test_renumber_is_permutation_and_groups():
    layout = DofLayout(BoxMesh.from_s(4), 2)
    gm = layout.gather_map
    perm, n_int = renumber.locality_permutation(gm, layout.n_nodes)
    assert sorted(perm) == list(range(layout.n_nodes))
    touch = np.bincount(gm.reshape(-1), minlength=layout.n_nodes)
    # interior (touch == 1) nodes occupy the first n_int new ids
    new_of_interior = perm[touch == 1]
    assert new_of_interior.max() == n_int - 1
    assert (touch == 1).sum() == n_int


def test_renumbered_operator_is_equivalent():
    """The general operator commutes with node renumbering."""
    from mf_data_locality.ops import laplace

    layout = DofLayout(BoxMesh.from_s(3), 2)
    op = laplace.make_operator(layout, dtype=jnp.float64)
    perm, _ = renumber.locality_permutation(layout.gather_map, layout.n_nodes)

    # renumber_operator also rebuilds the transposed scatter map — a
    # stale scatter_pos (round-3 regression) scatters to wrong nodes
    op2 = laplace.renumber_operator(op, perm)

    rng = np.random.default_rng(0)
    u = rng.normal(size=(3, layout.n_nodes))
    v1 = np.asarray(laplace.vmult(op, jnp.asarray(u)))
    u2 = renumber.permute_nodes(u, perm, axis=1)
    v2 = np.asarray(laplace.vmult(op2, jnp.asarray(u2)))
    v2_back = v2[:, perm]  # new->old: v_old[i] = v_new[perm[i]]
    assert np.abs(v2_back - v1).max() < 1e-12


def test_cellbatch_renumber_variants():
    """cellbatch_assembly / touch_count_cellbatch variants
    (renumber_dofs_for_mf.h:363-459, 592-671): batched sweep positions and
    batch-granular touch counts."""
    layout = DofLayout(BoxMesh.from_s(4), 2)
    gm = layout.gather_map
    n = layout.n_nodes

    perm_b, ni_b = renumber.locality_permutation(gm, n, batch_cells=4)
    assert sorted(perm_b) == list(range(n))
    # same interior count as the per-cell variant (interior = touch once)
    perm_c, ni_c = renumber.locality_permutation(gm, n)
    assert ni_b == ni_c
    # batching coarsens the order: nodes first touched by the same batch
    # keep their relative old order (stable tie-break)
    first_batch = np.full(n, 10**9, dtype=np.int64)
    npc = gm.shape[-1]
    pos = np.arange(gm.size) // (npc * 4)
    np.minimum.at(first_batch, gm.reshape(-1), pos)
    interior = np.bincount(gm.reshape(-1), minlength=n) == 1
    ids = np.where(interior & (first_batch == first_batch[interior.argmax()]))[0]
    if len(ids) > 1:
        assert (np.diff(perm_b[ids]) > 0).all()

    # batch-granular touch counts: every node becomes "touched once" when
    # one batch covers the whole mesh
    whole = gm.shape[0]
    perm_w, _ = renumber.locality_permutation(
        gm, n, grouping="touch_count_cellbatch", batch_cells=whole)
    assert sorted(perm_w) == list(range(n))
    pairs = np.unique(gm.reshape(-1).astype(np.int64))
    assert pairs.size == n  # all nodes in one batch -> one batch-touch each


def test_cellbatch_touch_count_grouping_partial():
    """With 2-cell batches, nodes shared only inside a batch group as
    touched-once while cross-batch shared nodes do not."""
    layout = DofLayout(BoxMesh.from_s(2), 1)  # 4 cells in a row-ish layout
    gm = layout.gather_map
    n = layout.n_nodes
    perm, n_int = renumber.locality_permutation_np(
        gm, n, grouping="touch_count_cellbatch", batch_cells=2)
    assert sorted(perm) == list(range(n))
    npc = gm.shape[-1]
    batch_of_slot = np.arange(gm.size) // (npc * 2)
    nb = int(batch_of_slot[-1]) + 1
    pairs = np.unique(gm.reshape(-1).astype(np.int64) * nb + batch_of_slot)
    touch_b = np.bincount(pairs // nb, minlength=n)
    # class-0 block = nodes with a single batch-touch; they come first
    cls0 = touch_b <= 1
    assert perm[cls0].max() == cls0.sum() - 1

