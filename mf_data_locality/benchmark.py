"""BP4 benchmark harness / CLI.

Capability of the reference harness (``common_code/benchmark.h:50-318`` and
the two ``bench.cc`` executables): degree dispatch, auto size ladder, the 4x
min-timed CG solve, the 2x50 min-timed matvec, and the fixed-width result
row, with the device the row was measured on appended::

   p |  q | n_element |     n_dofs |     time/it |   dofs/s/it | itCG | time/matvec | device

Usage (mirrors the reference positional CLI, ``benchmark.h:280-288``)::

   python -m mf_data_locality.benchmark <degree> [s] [compact] \
       [--solver merged|baseline] [--dtype f32|f64] \
       [--backend structured|general] [--devices N] [--overlap] \
       [--platform gpu|cpu]

The measurement runs on a GPU and fails without one; ``--platform cpu`` is
the explicit rehearsal on (virtual) CPU devices, and its rows say ``cpu``.

``s < 1`` runs the auto ladder: s starts at 1 + log2(n_devices) and grows
while (p+1)^3 * 2^s * n_components < 6e6 * n_devices (``benchmark.h:243-257``).
The degree dispatch table p=1..11 with q=p+2 matches ``benchmark.h:290-313``;
each (p, q) is a separate jit specialization — the XLA analog of the
reference's compile-time template instantiations.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from mf_data_locality.models import bp4
from mf_data_locality.utils import compile_cache, timing

DTYPES = {"f32": jnp.float32, "f64": jnp.float64}
HEADER = (" p |  q | n_element |     n_dofs |     time/it |   dofs/s/it |"
          " itCG | time/matvec | device")


@dataclass
class RunResult:
    degree: int
    n_q: int
    n_cells: int
    n_dofs: int
    time_per_it: float
    dofs_per_s_per_it: float
    n_iterations: int
    time_per_matvec: float
    converged: bool
    platform: str
    setup_time: float = 0.0  # host build + first solve (compilation included)

    def row(self) -> str:
        return (f"{self.degree:2d} | {self.n_q:2d} |{self.n_cells:10d} "
                f"|{self.n_dofs:11d} | {self.time_per_it:.5e} | "
                f"{self.dofs_per_s_per_it:.5e} | {self.n_iterations:4d} | "
                f"{self.time_per_matvec:.5e} | {self.platform}")


def device_identity(platform: str) -> tuple[str, str, int]:
    """(platform, device_kind, count) of JAX's devices.

    Raises SystemExit unless the default devices are on ``platform``: a
    measurement never falls back to another device.
    """
    devs = jax.devices()
    if devs[0].platform != platform:
        raise SystemExit(f"needs a {platform} device, JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    return devs[0].platform, devs[0].device_kind, len(devs)


def run_one(degree: int, s: int, solver: str = "merged", dtype=jnp.float32,
            backend: str = "structured", verbose: bool = False,
            solve_repeats: int = 4, matvec_repeats: int = 2,
            matvec_inner: int = 50, max_iter: int = 100) -> RunResult:
    """Set up and time one (p, s) benchmark point (``benchmark.h:50-226``).

    The operator data, preconditioner and right-hand side are arguments of
    the jitted solve, not constants folded into the program.
    """
    t0 = time.perf_counter()
    problem = bp4.build(s, degree, dtype=dtype, backend=backend)
    solve_fn = {"merged": bp4.solve_merged,
                "baseline": bp4.solve_baseline}[solver]

    @jax.jit
    def solve_jit(op, inv_diag, b):
        pr = dataclasses.replace(problem, op=op, inv_diag=inv_diag, b=b)
        return solve_fn(pr, max_iter=max_iter)

    @jax.jit
    def matvec(u, op):
        return dataclasses.replace(problem, op=op).a_apply_full(u)

    args = (problem.op, problem.inv_diag, problem.b)
    result = jax.block_until_ready(solve_jit(*args))  # warm-up: compiles
    setup_time = time.perf_counter() - t0
    n_it = int(result.n_iterations)
    if verbose:
        # reference verbose mode: diagonal norm + setup time
        # (benchmark.h:149-154, 178-182)
        diag_norm = float(jnp.linalg.norm(1.0 / problem.inv_diag))
        print(f"Norm of diagonal for preconditioner: {diag_norm:.6e}",
              file=sys.stderr)
        print(f"Setup time:         {setup_time:.3f}s", file=sys.stderr)
        hist = [float(r) for r in result.res_history[: n_it + 1]]
        print(f"  solver residual history: {hist[:4]} ... {hist[-2:]}",
              file=sys.stderr)

    solver_time = timing.time_min(lambda: solve_jit(*args),
                                  repeats=solve_repeats, warmup=0)
    matvec_time = timing.time_scan(matvec, problem.b, inner=matvec_inner,
                                   repeats=matvec_repeats,
                                   args=(problem.op,))
    return RunResult(
        degree=degree,
        n_q=degree + 2,
        n_cells=problem.layout.mesh.n_cells,
        n_dofs=problem.n_dofs,
        time_per_it=solver_time / max(n_it, 1),
        dofs_per_s_per_it=problem.n_dofs / solver_time * n_it,
        n_iterations=n_it,
        time_per_matvec=matvec_time,
        converged=bool(result.converged),
        platform=jax.devices()[0].platform,
        setup_time=setup_time,
    )


def run_one_distributed(degree: int, s: int, n_devices: int,
                        solver: str = "merged", dtype=jnp.float32,
                        backend: str = "structured", overlap: bool = False,
                        solve_repeats: int = 4, matvec_repeats: int = 2,
                        matvec_inner: int = 50,
                        max_iter: int = 100) -> RunResult:
    """Distributed solve + matvec timing over an n-device mesh.

    The multi-rank analog of the reference run: one 7-scalar psum per merged
    iteration, halo ppermutes inside the operator.  ``backend="structured"``
    decomposes the lattice into z-slabs; ``"general"`` decomposes the
    gather/scatter backend over cell chunks with rank-set halo grouping
    (``renumber_dofs_for_mf.h:492-535``).
    """
    t0 = time.perf_counter()
    if backend == "general":
        from mf_data_locality.parallel import dist_general

        dp, mesh = dist_general.build_dist_general(s, degree,
                                                   n_devices=n_devices,
                                                   dtype=dtype)

        def solve(d):
            return dist_general.solve_general(d, mesh, solver=solver,
                                              max_iter=max_iter)

        mv = dist_general.dist_matvec_jit(dp, mesh)
        mv_args = (dp.op_stack, dp.export_idx, dp.import_idx)
    else:
        from mf_data_locality.parallel import distributed as dist

        dp, mesh = dist.build_distributed(s, degree, n_devices=n_devices,
                                          dtype=dtype)

        def solve(d):
            return dist.solve(d, mesh, solver=solver, max_iter=max_iter,
                              overlap=overlap)

        mv = dist.dist_matvec_jit(dp, mesh, overlap=overlap)
        mv_args = (dp.op_stack,)
    # one jitted program for the whole solve, traced and compiled once
    solve_jit = jax.jit(solve)
    result = jax.block_until_ready(solve_jit(dp))
    setup_time = time.perf_counter() - t0
    n_it = int(result.n_iterations)
    solver_time = timing.time_min(lambda: solve_jit(dp),
                                  repeats=solve_repeats, warmup=0)
    matvec_time = timing.time_scan(lambda u, *a: mv(*a, u), dp.b,
                                   inner=matvec_inner, repeats=matvec_repeats,
                                   args=mv_args)
    return RunResult(
        degree=degree, n_q=degree + 2,
        n_cells=dp.n_cells, n_dofs=dp.n_dofs,
        time_per_it=solver_time / max(n_it, 1),
        dofs_per_s_per_it=dp.n_dofs / solver_time * n_it,
        n_iterations=n_it,
        time_per_matvec=matvec_time,
        converged=bool(result.converged),
        platform=jax.devices()[0].platform,
        setup_time=setup_time,
    )


def ladder_sizes(degree: int, n_components: int = 3,
                 n_devices: int | None = None) -> list[int]:
    """The reference auto size ladder (``benchmark.h:243-257``)."""
    nd = n_devices or jax.device_count()
    s = 1 + int(math.log2(nd))
    out = []
    while (degree + 1) ** 3 * (1 << s) * n_components < 6_000_000 * nd:
        out.append(s)
        s += 1
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("degree", type=int, nargs="?", default=1)
    ap.add_argument("s", type=int, nargs="?", default=-1,
                    help="mesh size exponent (2^s cells); <1 runs the ladder")
    ap.add_argument("compact", type=int, nargs="?", default=1)
    ap.add_argument("--solver", choices=["merged", "baseline"],
                    default="merged")
    ap.add_argument("--dtype", choices=list(DTYPES), default="f32")
    ap.add_argument("--backend", choices=["structured", "general"],
                    default="structured")
    ap.add_argument("--devices", type=int, default=0,
                    help="distribute over N devices (0 = single-device path)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap halo exchange with interior compute "
                         "(distributed structured path)")
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                    help="gpu (default): measure on the GPU, fail without "
                         "one; cpu: rehearse on virtual CPU devices "
                         "(enough for --devices N)")
    args = ap.parse_args(argv)

    if not 1 <= args.degree <= 11:
        raise SystemExit("Only degrees 1..11 implemented")  # benchmark.h:313

    if args.platform == "cpu":
        # XLA_FLAGS must carry the virtual device count before the CPU
        # backend initializes
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count="
                f"{max(args.devices, 1)}").strip()
        jax.config.update("jax_platforms", "cpu")
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    platform, kind, count = device_identity(args.platform)
    compile_cache.enable()

    dtype = DTYPES[args.dtype]
    sizes = ([args.s] if args.s >= 1
             else ladder_sizes(args.degree,
                               n_devices=args.devices or None))
    print(f"# device: {platform} {kind} x{count}")
    print(HEADER)
    for s in sizes:
        if args.devices > 0:
            r = run_one_distributed(args.degree, s, args.devices,
                                    solver=args.solver, dtype=dtype,
                                    backend=args.backend, overlap=args.overlap)
        else:
            r = run_one(args.degree, s, solver=args.solver, dtype=dtype,
                        backend=args.backend, verbose=not args.compact)
        print(r.row() + ("" if r.converged else "   [not converged]"))


if __name__ == "__main__":
    main()
