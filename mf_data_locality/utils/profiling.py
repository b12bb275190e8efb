"""Profiling hooks: marker regions and trace capture.

Capability of the reference's LIKWID hardware-counter regions
(``benchmark.h:23-25,186-215`` — regions "cg_solver" and "matvec" behind
``LIKWID_PERFMON``): on the accelerator the equivalent observability is a
jax profiler trace, with named annotations marking the same regions.

Usage::

    from mf_data_locality.utils import profiling

    with profiling.trace("/tmp/bp4_trace"):       # LIKWID_MARKER_INIT/CLOSE
        with profiling.marker("cg_solver"):       # LIKWID_MARKER_START/STOP
            result = solve(...)
            jax.block_until_ready(result)

View with TensorBoard / xprof, or reduce it with
:mod:`~mf_data_locality.utils.trace_summary`.  Both helpers are no-ops when
profiling is unavailable on the backend, so instrumented code runs everywhere.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace into ``log_dir`` (LIKWID_MARKER_INIT slot)."""
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:  # backend without profiling support
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


@contextlib.contextmanager
def marker(name: str) -> Iterator[None]:
    """Named region annotation (LIKWID_MARKER_START/STOP slot)."""
    try:
        with jax.profiler.TraceAnnotation(name):
            yield
    except Exception:
        yield
