"""Timing/profiling utility coverage (protocol correctness, not speed)."""

import jax
import jax.numpy as jnp

from mf_data_locality.utils import profiling, timing


def test_time_min_fetch_measures_something():
    x = jnp.ones((1000,))
    f = jax.jit(lambda v: jnp.sum(v * 2.0))
    t = timing.time_min(lambda: f(x), repeats=2)
    assert t > 0


def test_time_scan_fetch_shape_preserving_step():
    x = jnp.ones((64, 64))
    t = timing.time_scan(lambda v: v * 1.0001, x, inner=5, repeats=2)
    assert t > 0
    # extra operands travel as arguments of the chained step
    t = timing.time_scan(lambda v, w: v * w, x, inner=5, repeats=2,
                         args=(jnp.full((64, 64), 1.0001),))
    assert t > 0


def test_bandwidth_measurement_plausible():
    bw = timing.measure_hbm_bandwidth(nbytes=1 << 22)
    assert bw > 1e8  # > 0.1 GB/s on any real machine


def test_profiling_helpers_are_safe_everywhere():
    # must be no-ops (not errors) on backends without profiler support
    with profiling.marker("matvec"):
        x = jnp.ones(8) * 2
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            with profiling.marker("cg_solver"):
                y = jnp.sum(x)
    assert float(y) == 16.0
