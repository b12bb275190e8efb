"""Headline benchmark: BP4 merged-CG throughput on one GPU.

Prints ONE JSON line ``{"metric", "value", "unit", "vs_baseline", "device"}``
on standard output, and the details on standard error.

Metric: DoFs/s per CG iteration of the fully-merged solver (the CEED
throughput metric, ``benchmark.h:222``) at p=4, s=16 (12.8M DoFs, f32 vectors
of 51 MB each: a working set well above the card's 50 MB L2), on the plain
XLA path (structured lattice operator + merged CG).  ``vs_baseline``: the
fraction of the memory-bandwidth roofline, computed from the triad bandwidth
measured in the same process and the merged solver's ideal traffic of ~9 f32
words per DoF per iteration (BASELINE.md — the reference publishes no
numbers).

Needs a GPU: it exits non-zero, printing no result, when JAX finds none.
"""

from __future__ import annotations

import json
import sys


def main() -> None:
    import jax
    import jax.numpy as jnp

    from mf_data_locality.benchmark import device_identity, run_one
    from mf_data_locality.utils import compile_cache, timing

    platform, kind, count = device_identity("gpu")
    compile_cache.enable()

    degree, s = 4, 16
    bw = timing.measure_hbm_bandwidth()
    r = run_one(degree, s, solver="merged", dtype=jnp.float32,
                backend="structured", solve_repeats=3, matvec_repeats=2,
                matvec_inner=20)
    ideal_bytes_per_dof_per_it = 9 * 4  # x,g,d,h sweeps + diag + geometry (f32)
    roofline = bw / ideal_bytes_per_dof_per_it
    print(f"# n_dofs={r.n_dofs} itCG={r.n_iterations} "
          f"time/it={r.time_per_it:.6e}s time/matvec={r.time_per_matvec:.6e}s "
          f"measured_bw={bw:.6e}B/s roofline={roofline:.6e}DoF/s/it "
          f"setup={r.setup_time:.3f}s converged={r.converged} "
          f"device={kind} x{jax.device_count()}", file=sys.stderr)
    print(json.dumps({
        "metric": f"bp4_merged_cg_dofs_per_s_per_it_p{degree}",
        "value": r.dofs_per_s_per_it,
        "unit": "DoF/s/iter",
        "vs_baseline": r.dofs_per_s_per_it / roofline,
        "device": {"platform": platform, "kind": kind, "count": count},
    }))


if __name__ == "__main__":
    main()
