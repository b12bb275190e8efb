"""Benchmark timing protocol.

Reproduces the reference measurement protocol (``common_code/benchmark.h:
184-215``): min over repeats of wall time, warmup before timing
(``curved_manifold.h:90-106`` — here: jit compile + one discarded run).

JAX dispatches asynchronously, so every timed call ends in
``jax.block_until_ready`` on its result: the host clock then covers the
device work, not just the enqueue.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp


def time_min(fn: Callable[[], object], repeats: int,
             warmup: int = 1) -> float:
    """Min over ``repeats`` of the wall time of ``fn()`` run to completion."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def time_scan(step: Callable[..., jax.Array], x0: jax.Array, inner: int,
              repeats: int, warmup: int = 1, args: tuple = ()) -> float:
    """Time one application of ``step`` by chaining applications on device.

    The analog of the reference's 50-matvec inner loop
    (``benchmark.h:204-215``): ``x -> step(x, *args)`` is scanned ``inner``
    and ``2*inner`` times inside one jitted computation each, and the
    per-apply time is the slope (t_2L - t_L) / L, which cancels every
    per-chain fixed cost (dispatch, scan setup).  ``args`` are passed as
    arguments, not folded into the program as constants.  A non-positive
    slope (a chain too short to rise above timer noise) falls back to the
    long-chain quotient.
    """

    def make_chain(length):
        @jax.jit
        def chain(x, *a):
            def body(c, _):
                return step(c, *a), None
            out, _ = jax.lax.scan(body, x, None, length=length)
            return out
        return chain

    chain, chain2 = make_chain(inner), make_chain(2 * inner)
    t1 = time_min(lambda: chain(x0, *args), repeats=repeats, warmup=warmup)
    t2 = time_min(lambda: chain2(x0, *args), repeats=repeats, warmup=warmup)
    slope = (t2 - t1) / inner
    return slope if slope > 0 else t2 / (2 * inner)


def measure_hbm_bandwidth(nbytes: int = 1 << 28) -> float:
    """Measured triad-style memory bandwidth (bytes/s) on the default device.

    The denominator of ``bench.py``'s roofline fraction, measured in the same
    process as the solve it is compared with.
    """
    n = nbytes // 4
    a = jnp.ones((n,), jnp.float32)
    b = jnp.full((n,), 2.0, jnp.float32)
    t = time_scan(lambda x, y: x + 0.5 * y, a, inner=20, repeats=3,
                  args=(b,))
    return 3 * n * 4 / t
