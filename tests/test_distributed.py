"""Distributed solves on 8 virtual CPU devices vs single-device reference.

SURVEY.md §4(d): 1-device vs N-device results identical to roundoff using the same
global mesh — the "multi-node testing without a cluster" strategy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality.models import bp4
from mf_data_locality.parallel import distributed as dist


requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@requires_8
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_distributed_merged_matches_single(n_dev):
    s, p = 9, 2  # ncz = 8 slabs available
    ref = bp4.build(s, p, dtype=jnp.float64)
    r1 = bp4.solve_merged(ref)

    dp, mesh = dist.build_distributed(s, p, n_devices=n_dev,
                                      dtype=jnp.float64)
    rd = dist.solve(dp, mesh, solver="merged")

    assert int(rd.n_iterations) == int(r1.n_iterations)
    assert np.isclose(float(rd.res_norm), float(r1.res_norm), rtol=1e-9)
    xg = dist.gather_global(rd.x).reshape(3, -1)
    x1 = np.asarray(r1.x).reshape(3, -1)
    assert np.abs(xg - x1).max() < 1e-10 * max(np.abs(x1).max(), 1.0)


@requires_8
def test_distributed_baseline_matches_single():
    s, p = 9, 2
    ref = bp4.build(s, p, dtype=jnp.float64)
    r1 = bp4.solve_baseline(ref)

    dp, mesh = dist.build_distributed(s, p, n_devices=4,
                                      dtype=jnp.float64)
    rd = dist.solve(dp, mesh, solver="baseline")
    assert int(rd.n_iterations) == int(r1.n_iterations)
    xg = dist.gather_global(rd.x).reshape(3, -1)
    x1 = np.asarray(r1.x).reshape(3, -1)
    assert np.abs(xg - x1).max() < 1e-10 * max(np.abs(x1).max(), 1.0)


@requires_8
def test_distributed_matvec_matches_single():
    """One distributed vmult == single-device vmult (halo-sum correctness)."""
    from jax.sharding import PartitionSpec as P

    s, p = 6, 3  # ncz = 4
    ref = bp4.build(s, p, dtype=jnp.float64)
    v1 = np.asarray(ref.a_apply_full(ref.b))

    dp, mesh = dist.build_distributed(s, p, n_devices=4,
                                      dtype=jnp.float64)

    def body(op_stack, b):
        op_local = jax.tree.map(lambda x: x[0], op_stack)
        out = dist.dist_vmult(op_local, b[0], n_dev=4,
                              constrained_identity=True)
        return out[None]

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(dist.AXIS), P(dist.AXIS)),
                       out_specs=P(dist.AXIS), check_vma=False)
    vd = dist.gather_global(jax.jit(fn)(dp.op_stack, dp.b))
    assert np.abs(vd - v1.reshape(vd.shape)).max() < 1e-12 * np.abs(v1).max()


@requires_8
def test_replication_invariant_preserved():
    """After a solve, shared planes remain bit-replicated across devices."""
    dp, mesh = dist.build_distributed(9, 2, n_devices=8,
                                      dtype=jnp.float64)
    rd = dist.solve(dp, mesh, solver="merged")
    x = np.asarray(rd.x)
    for d in range(1, 8):
        np.testing.assert_array_equal(x[d - 1][:, -1], x[d][:, 0])


@requires_8
def test_overlapped_halo_exchange_matches():
    """Boundary-first apply with overlapped compress transfer == plain path.

    (SURVEY.md §2 parallelism item 3: comm/compute overlap.)"""
    s, p, D = 12, 1, 4  # ncz = 16 -> 4 cell layers per device
    dp, mesh = dist.build_distributed(s, p, n_devices=D, dtype=jnp.float64)
    r_plain = dist.solve(dp, mesh, solver="merged", max_iter=30)
    r_over = dist.solve(dp, mesh, solver="merged", max_iter=30, overlap=True)
    assert int(r_plain.n_iterations) == int(r_over.n_iterations)
    xp_ = np.asarray(r_plain.x)
    xo = np.asarray(r_over.x)
    assert np.abs(xp_ - xo).max() < 1e-12 * max(np.abs(xp_).max(), 1.0)


@requires_8
@pytest.mark.parametrize("n_dev", [3, 5, 6, 7])
def test_distributed_arbitrary_device_count_structured(n_dev):
    """ncz=8 over 3/5/6/7 devices: dummy-padded slabs preserve exactness."""
    s, p = 9, 2
    ref = bp4.build(s, p, dtype=jnp.float64)
    r1 = bp4.solve_merged(ref, max_iter=25)

    dp, mesh = dist.build_distributed(s, p, n_devices=n_dev,
                                      dtype=jnp.float64)
    rd = dist.solve(dp, mesh, solver="merged", max_iter=25)
    assert int(rd.n_iterations) == int(r1.n_iterations)
    nz = (8 * p) + 1
    xg = dist.gather_global(rd.x, nz=nz).reshape(3, -1)
    x1 = np.asarray(r1.x).reshape(3, -1)
    assert np.abs(xg - x1).max() < 1e-10 * max(np.abs(x1).max(), 1.0)


@requires_8
def test_overlap_fallback_small_slabs():
    """ncz_loc < 3 falls back to the plain path without error."""
    dp, mesh = dist.build_distributed(9, 2, n_devices=8, dtype=jnp.float64)
    r = dist.solve(dp, mesh, solver="merged", max_iter=10, overlap=True)
    assert int(r.n_iterations) == 10


@requires_8
@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (3, 2)])
def test_distributed_2d_matches_single(shape):
    """2D (z x y) decomposition == single device (dimension-split halo
    sums resolve edge contributions implicitly); (3,2) exercises
    non-divisible padding in z."""
    s, p = 9, 2
    ref = bp4.build(s, p, dtype=jnp.float64)
    r1 = bp4.solve_merged(ref, max_iter=25)
    dp, mesh = dist.build_distributed_2d(s, p, shape, dtype=jnp.float64)
    rd = dist.solve_2d(dp, mesh, max_iter=25)
    assert int(rd.n_iterations) == int(r1.n_iterations)
    nzy = 8 * p + 1
    xg = dist.gather_global_2d(rd.x, nz=nzy, ny=nzy).reshape(3, -1)
    x1 = np.asarray(r1.x).reshape(3, -1)
    assert np.abs(xg - x1).max() < 1e-10 * max(np.abs(x1).max(), 1.0)


@requires_8
def test_distributed_2d_replication_invariant():
    dp, mesh = dist.build_distributed_2d(9, 2, (2, 4), dtype=jnp.float64)
    rd = dist.solve_2d(dp, mesh, max_iter=15)
    x = np.asarray(rd.x)
    for dz in range(2):
        for dy in range(1, 4):
            np.testing.assert_array_equal(x[dz, dy - 1][:, :, -1],
                                          x[dz, dy][:, :, 0])
    for dz in range(1, 2):
        for dy in range(4):
            np.testing.assert_array_equal(x[dz - 1, dy][:, -1], x[dz, dy][:, 0])


@requires_8
@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4), (3, 2, 1)])
def test_distributed_3d_matches_single(shape):
    """Full 3D decomposition: three sequential per-axis halo sums resolve
    edges AND corners implicitly; (3,2,1) exercises non-divisible padding."""
    s, p = 6, 2  # mesh (4, 4, 4)
    ref = bp4.build(s, p, dtype=jnp.float64)
    r1 = bp4.solve_merged(ref, max_iter=20)
    dp, mesh = dist.build_distributed_3d(s, p, shape, dtype=jnp.float64)
    rd = dist.solve_3d(dp, mesh, max_iter=20)
    assert int(rd.n_iterations) == int(r1.n_iterations)
    nn = 4 * p + 1
    xg = dist.gather_global_3d(rd.x, nz=nn, ny=nn, nx=nn).reshape(3, -1)
    x1 = np.asarray(r1.x).reshape(3, -1)
    assert np.abs(xg - x1).max() < 1e-10 * max(np.abs(x1).max(), 1.0)
