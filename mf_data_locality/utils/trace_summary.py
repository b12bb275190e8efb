"""Offline summarization of jax.profiler traces (no TensorBoard needed).

The capability slot of the reference's LIKWID hardware-counter reports
(``benchmark.h:186-215``): after capturing a trace with
:func:`utils.profiling.trace`, these helpers read the ``.xplane.pb`` that
the profiler writes (through ``jax.profiler.ProfileData``) and aggregate the
durations of the operations that ran on the GPU, so kernel/copy cost
breakdowns are scriptable.

Only GPU device planes (``/device:GPU:<n>``) count.  On each, the
``XLA Ops`` line (one event per HLO operation) is read when the profiler
wrote one; otherwise the CUDA stream lines (one event per kernel) are.
"""

from __future__ import annotations

import glob
import os

from jax.profiler import ProfileData

DEVICE_PLANE_PREFIX = "/device:GPU:"


def _device_events(log_dir: str):
    """Yield (name, dur_us) for operations on the GPU planes of the newest
    trace under ``log_dir`` (nothing if no trace was written)."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        return
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    for plane in data.planes:
        if not plane.name.startswith(DEVICE_PLANE_PREFIX):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"]
        for line in ops or [ln for ln in lines if ln.name.startswith("Stream")]:
            for ev in line.events:
                yield ev.name, ev.duration_ns / 1e3


def op_durations(log_dir: str) -> dict[str, float]:
    """Total device time (us) per op name over the captured window."""
    out: dict[str, float] = {}
    for name, dur in _device_events(log_dir):
        out[name] = out.get(name, 0.0) + dur
    return out


def top_ops(log_dir: str, n: int = 25) -> list[tuple[str, float]]:
    """The n device ops with the largest total duration (us)."""
    return sorted(op_durations(log_dir).items(), key=lambda kv: -kv[1])[:n]


def total_matching(log_dir: str, prefix: str) -> float:
    """Total device time (us) of ops whose name starts with ``prefix``
    (e.g. ``"copy"`` to quantify XLA buffer copies)."""
    return sum(d for nm, d in op_durations(log_dir).items()
               if nm.startswith(prefix))
