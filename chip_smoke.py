"""On-card smoke test of the BP4 main path (one NVIDIA GPU).

Run from the repository root::

    python chip_smoke.py               # phases (a)-(f) on one card
    python chip_smoke.py --four-cards  # only the 4-card distributed phase

Phases, each checked against the repository's own plain references:

(a) the card (``nvidia-smi`` name and power limit) and JAX's devices; the
    script refuses anything but a GPU;
(b) operator: structured lattice path vs the general gather/scatter path,
    f64, p=4, s=12 — max relative error <= 1e-12 (summation order only);
(c) precision: structured f32 vs structured f64, p=4, s=16 — max relative
    error <= 1e-5 (an f32 contraction run in TF32 shows about 1e-3);
(d) solvers: merged vs baseline CG, f64, p=4, s=12, up to 500 iterations —
    identical iteration counts, both converged to the 1e-8 reduction, true
    residual ||b - A x|| / ||b|| computed and printed;
(e) main path: ``benchmark.run_one(4, 16, solver="merged")`` in f32 — the
    result row, the device's peak memory and the set-up (compile) time;
(f) trace: a ``jax.profiler`` trace of 10 merged-CG iterations, f32, p=4,
    s=16, reduced by ``utils/trace_summary`` to the top device ops (the trace
    is kept under ``build/trace_p4s16``).

``--four-cards`` runs the 1D z-slab merged CG of ``parallel/distributed.py``
on 4 GPUs against the same problem on one card in this process (f64, p=4,
s=15, 1e-8 reduction: identical iterations, solution max relative difference
<= 1e-10), then prints the f32 p=4 s=18 row on 4 cards.

The last line of standard output is ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero before that line is printed.  One process uses
the card(s); no child process touches JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import time

import numpy as np


def last_line(platform: str, kind: str, count: int) -> str:
    """The result line the smoke test ends with."""
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind, "count": count}})


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def max_rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def solve(problem, solve_fn, max_iter: int):
    """Run ``solve_fn`` (bp4.solve_merged / solve_baseline) jitted, with the
    problem's arrays as arguments."""
    import jax

    @jax.jit
    def f(op, inv_diag, b):
        pr = dataclasses.replace(problem, op=op, inv_diag=inv_diag, b=b)
        return solve_fn(pr, max_iter=max_iter)

    return jax.block_until_ready(f(problem.op, problem.inv_diag, problem.b))


def true_residual(problem, x) -> float:
    import jax
    import jax.numpy as jnp

    @jax.jit
    def rel(op, b, x):
        pr = dataclasses.replace(problem, op=op, b=b)
        return jnp.linalg.norm(b - pr.a_apply_full(x)) / jnp.linalg.norm(b)

    return float(rel(problem.op, problem.b, x))


def phase_operator(rng) -> None:
    import jax
    import jax.numpy as jnp

    from mf_data_locality.mesh.box import BoxMesh
    from mf_data_locality.mesh.dofs import DofLayout
    from mf_data_locality.ops import laplace, laplace_structured as ls

    layout = DofLayout(BoxMesh.from_s(12), 4)
    u = rng.standard_normal((3, layout.n_nodes))
    op_g = laplace.make_operator(layout, dtype=jnp.float64)
    op_s = ls.make_structured_operator(layout, dtype=jnp.float64)
    vg = jax.jit(laplace.vmult)(op_g, jnp.asarray(u))
    vs = jax.jit(ls.vmult)(op_s, jnp.asarray(u).reshape(
        (3,) + layout.n_nodes_axis))
    err = max_rel(np.asarray(vs).reshape(3, -1), vg)
    print(f"(b) structured vs general, f64, p=4 s=12 ({3 * layout.n_nodes} "
          f"DoFs): max rel error {err:.3e} (limit 1e-12)")
    check(err <= 1e-12, "(b) structured vs general operator")


def phase_precision(rng) -> None:
    import jax
    import jax.numpy as jnp

    from mf_data_locality.mesh.box import BoxMesh
    from mf_data_locality.mesh.dofs import DofLayout
    from mf_data_locality.ops import laplace_structured as ls

    layout = DofLayout(BoxMesh.from_s(16), 4)
    u = jnp.asarray(rng.standard_normal((3,) + layout.n_nodes_axis))
    apply = jax.jit(ls.vmult)
    v64 = apply(ls.make_structured_operator(layout, dtype=jnp.float64), u)
    v32 = apply(ls.make_structured_operator(layout, dtype=jnp.float32),
                u.astype(jnp.float32))
    check(v32.dtype == jnp.float32, "(c) f32 operator output dtype")
    err = max_rel(v32, v64)
    print(f"(c) structured f32 vs f64, p=4 s=16 ({u.size} DoFs): max rel "
          f"error {err:.3e} (limit 1e-5)")
    check(bool(np.isfinite(err)) and err <= 1e-5, "(c) f32 vs f64 operator")


def phase_solvers() -> None:
    import jax.numpy as jnp

    from mf_data_locality.models import bp4

    problem = bp4.build(12, 4, dtype=jnp.float64)
    rm = solve(problem, bp4.solve_merged, max_iter=500)
    rb = solve(problem, bp4.solve_baseline, max_iter=500)
    itm, itb = int(rm.n_iterations), int(rb.n_iterations)
    tm, tb = true_residual(problem, rm.x), true_residual(problem, rb.x)
    print(f"(d) merged vs baseline CG, f64, p=4 s=12 ({problem.n_dofs} DoFs): "
          f"itCG {itm} vs {itb}, converged {bool(rm.converged)} / "
          f"{bool(rb.converged)}, true residual {tm:.3e} / {tb:.3e}")
    check(itm == itb, "(d) merged and baseline iteration counts")
    check(bool(rm.converged) and bool(rb.converged), "(d) convergence")
    check(tm < 2e-8 and tb < 2e-8, "(d) true residual")


def phase_main_path() -> None:
    import jax
    import jax.numpy as jnp

    from mf_data_locality import benchmark

    r = benchmark.run_one(4, 16, solver="merged", dtype=jnp.float32)
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    print("(e) main path, f32, p=4 s=16:")
    print(benchmark.HEADER)
    print(r.row() + ("" if r.converged else "   [not converged]"))
    print(f"(e) set-up (build + compile) {r.setup_time:.3f} s, peak device "
          f"memory {peak} bytes")
    check(r.n_dofs == 3 * 129 * 129 * 257 and r.n_iterations >= 1,
          "(e) problem size and iterations")
    check(bool(np.isfinite(r.time_per_it)) and r.time_per_it > 0
          and r.time_per_matvec > 0, "(e) timings")


def phase_trace() -> None:
    import jax
    import jax.numpy as jnp

    from mf_data_locality.models import bp4
    from mf_data_locality.utils import profiling, trace_summary

    n_it = 10
    problem = bp4.build(16, 4, dtype=jnp.float32)

    @jax.jit
    def f(op, inv_diag, b):
        pr = dataclasses.replace(problem, op=op, inv_diag=inv_diag, b=b)
        return bp4.solve_merged(pr, max_iter=n_it)

    args = (problem.op, problem.inv_diag, problem.b)
    jax.block_until_ready(f(*args))  # compile outside the trace
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "trace_p4s16")
    shutil.rmtree(log_dir, ignore_errors=True)
    with profiling.trace(log_dir):
        r = jax.block_until_ready(f(*args))
    total = sum(trace_summary.op_durations(log_dir).values())
    print(f"(f) trace of {int(r.n_iterations)} merged-CG iterations, f32, "
          f"p=4 s=16: {total:.1f} us of device op time; top device ops:")
    for name, us in trace_summary.top_ops(log_dir, 10):
        print(f"    {us:10.1f} us {100 * us / total:5.1f}%  {name[:100]}")
    check(int(r.n_iterations) == n_it and total > 0,
          "(f) the trace holds the iterations' device ops")


def phase_four_cards() -> None:
    import jax
    import jax.numpy as jnp

    from mf_data_locality import benchmark
    from mf_data_locality.models import bp4
    from mf_data_locality.parallel import distributed as dist

    check(len(jax.devices()) >= 4, "--four-cards needs 4 GPUs")
    s, p = 15, 4
    max_iter = 2000  # about 620 iterations reach the 1e-8 reduction here
    problem = bp4.build(s, p, dtype=jnp.float64)
    dp, mesh = dist.build_distributed(s, p, n_devices=4, dtype=jnp.float64)
    t0 = time.perf_counter()
    r1 = solve(problem, bp4.solve_merged, max_iter=max_iter)
    rd = jax.block_until_ready(jax.jit(
        lambda d: dist.solve(d, mesh, solver="merged",
                             max_iter=max_iter))(dp))
    it1, itd = int(r1.n_iterations), int(rd.n_iterations)
    diff = max_rel(dist.gather_global(rd.x).reshape(3, -1),
                   np.asarray(r1.x).reshape(3, -1))
    print(f"(4 cards) merged CG to a 1e-8 reduction, f64, p={p} s={s} "
          f"({dp.n_dofs} DoFs): itCG {itd} on 4 cards vs {it1} on 1, "
          f"converged {bool(rd.converged)} / {bool(r1.converged)}, solution "
          f"max rel difference {diff:.3e} (limit 1e-10), "
          f"{time.perf_counter() - t0:.1f} s")
    check(itd == it1, "(4 cards) iteration counts")
    check(bool(rd.converged) and bool(r1.converged), "(4 cards) converged")
    check(diff <= 1e-10, "(4 cards) solution difference (limit 1e-10)")

    r = benchmark.run_one_distributed(4, 18, 4, solver="merged",
                                      dtype=jnp.float32)
    print("(4 cards) merged CG, f32, p=4 s=18:")
    print(benchmark.HEADER)
    print(r.row() + ("" if r.converged else "   [not converged]"))
    print(f"(4 cards) set-up (build + compile) {r.setup_time:.3f} s")
    check(r.n_iterations >= 1 and r.time_per_it > 0, "(4 cards) f32 row")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card distributed phase")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    from mf_data_locality.benchmark import device_identity
    from mf_data_locality.utils import compile_cache

    platform, kind, count = device_identity("gpu")
    compile_cache.enable()
    print(card_line())
    print(f"(a) jax: platform={platform} kind={kind} count={count}")

    phases = ([phase_four_cards] if args.four_cards else
              [lambda: phase_operator(np.random.default_rng(0)),
               lambda: phase_precision(np.random.default_rng(1)),
               phase_solvers, phase_main_path, phase_trace])
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        print(f"    phase time {time.perf_counter() - t0:.1f} s", flush=True)
    print(last_line(platform, kind, count))


if __name__ == "__main__":
    main()
