"""Fully-merged conjugate gradient: one reduction of 7 scalars per iteration.

Capability of ``SolverCGFullMerge`` + ``do_cg_update3b/4b`` (reference:
``common_code/solver_cg_optimized.h:12-161,190-302``), the repository's
headline contribution.  Per iteration the classical PCG needs 2-3 separate
all-reduces and ~4 distinct sweeps over the vectors; this formulation:

* rearranges the recurrences so all reduction data for one iteration comes
  from **seven fused dot products** over (g, d, h, prec) — a single
  length-7 reduction (reference: one ``MPI_Allreduce`` of 7 doubles,
  ``poisson_operator.h:373-375``; here: one fused XLA reduction, and a single
  ``psum`` over the device mesh when distributed);
* estimates the new residual norm from those sums via the sigma-trick
  ``||r + alpha h||^2 = s3 + 2 alpha s2 + alpha^2 s1`` — no extra pass;
* **delays the x update**: x is touched only every second iteration with the
  two-step combined coefficient ``x += (alpha_k + alpha_{k-1}/beta_{k-1}) p_k
  + (alpha_{k-1}/beta_{k-1}) P g_{k-1}`` (derived from
  ``p_k = beta_{k-1} p_{k-1} - P g_{k-1}``), halving x-traffic;
* uses the Polak-Ribiere-form ``beta = alpha (s4 + alpha s5) / s6`` so beta
  needs no extra reduction.

Here the reference's pre/post range callbacks (vector updates fused into
the operator's cell sweep) become *compiler-level* fusion: the whole
iteration body — update4b, operator apply, update3b — is one jitted region,
so XLA fuses the elementwise sweeps with the gather/scatter edges of the
operator.  State convention: ``g = A x - b`` (the reference's sign), search
direction d with ``x += alpha d``.

The solve matches the reference recurrence exactly, so float64 runs agree
with a textbook PCG run to roundoff and iteration counts are identical —
the reference's own correctness invariant (SURVEY.md §4).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from mf_data_locality.solvers.cg import SolveResult


def merged_cg_solve(
    a_apply: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    prec: jax.Array,
    x0: jax.Array | None = None,
    max_iter: int = 100,
    abs_tol: float = 1e-15,
    rel_tol: float = 1e-8,
    reduce_sums: Callable[[jax.Array], jax.Array] | None = None,
    dot_weight: jax.Array | None = None,
) -> SolveResult:
    """Solve A x = b with the fully-merged CG.

    ``x0``: optional initial guess — the initial residual is then
    ``g = A x0 - b`` (``solver_cg_optimized.h:221-228``); ``None`` keeps the
    benchmark's x0 = 0 fast path (g = -b, no extra operator apply).

    ``reduce_sums`` post-processes the 7-vector of local partial sums — the
    distributed path passes ``lambda s: jax.lax.psum(s, axis_name)`` so the
    whole iteration has exactly one collective.  ``dot_weight`` (broadcastable
    against ``b``) weights the local dot products — the distributed path uses
    it to zero out non-owned replicated DoFs so the psum counts each global
    DoF exactly once (the role of the reference partitioner's owned-range
    split).

    Reduced-precision storage (``vector_access_reduced.h`` capability,
    generalized to actual reduced precision): when ``b`` is bfloat16 the
    *operator-stream* vectors d and h — the matvec input/output, which
    dominate per-iteration HBM traffic — are stored in bf16, while x and g
    stay float32: they carry the convergence state, and bf16's 8-bit
    mantissa would stall the recurrence near 1e-3 relative residual.  All
    dot products and scalar recurrences accumulate in float32.
    """
    dtype = b.dtype
    # accumulation dtype: never accumulate dots/updates in bf16.  x and g
    # are stored at acc precision; only d and h at the storage dtype.
    acc = jnp.float32 if dtype == jnp.bfloat16 else dtype
    if reduce_sums is None:
        reduce_sums = lambda s: s  # noqa: E731
    prec_a = prec.astype(acc)

    def wdot(a, c):
        a = a.astype(acc)
        c = c.astype(acc)
        if dot_weight is None:
            return jnp.vdot(a, c, precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(a * c * dot_weight)

    def dots7(g, d, h):
        """The update3b fused dot products (solver_cg_optimized.h:12-61)."""
        ph = prec_a * h.astype(acc)
        pg = prec_a * g.astype(acc)
        local = jnp.stack([
            wdot(d, h), wdot(h, h), wdot(g, h), wdot(g, g),
            wdot(g, ph), wdot(h, ph), wdot(g, pg),
        ]).astype(acc)
        return reduce_sums(local)

    def update4b(x, g, d, h, alpha, beta, alpha_old_eff, beta_old):
        """Vector updates preceding the sweep (solver_cg_optimized.h:65-161).

        The reference branches three ways (first iteration, delayed-x
        iteration, steady state) for CPU efficiency; here the branches
        collapse into one *unconditional* fused sweep with two predicated
        scalar coefficients — identical arithmetic in every case:

          first (alpha = 0):       g' = g (alpha=0), d' = -P g (beta=0), x' = x
          delayed (alpha_old = 0): x' = x,  g' = g + alpha h,  d' = beta d - P g'
          steady:                  x' = x + (alpha + a/b) d + (a/b) P g, ...
        """
        is_delayed_pay = alpha_old_eff != 0
        safe_b = jnp.where(beta_old == 0, 1.0, beta_old)
        aob = jnp.where(is_delayed_pay, alpha_old_eff / safe_b, zero)
        c1 = jnp.where(is_delayed_pay, alpha + aob, zero)

        xa, ga, da, ha = (v.astype(acc) for v in (x, g, d, h))
        pg = prec_a * ga
        x2 = xa + c1 * da + aob * pg
        g2 = ga + alpha * ha
        d2 = beta * da - prec_a * g2
        return x2, g2, d2.astype(dtype)

    # initial residual g = A x0 - b, or -b for the x0 = 0 fast path
    if x0 is None:
        g0 = -b.astype(acc)
        x_init = jnp.zeros_like(b, dtype=acc)
    else:
        x_init = x0.astype(acc)
        g0 = a_apply(x_init.astype(dtype)).astype(acc) - b.astype(acc)
    res0 = jnp.sqrt(reduce_sums(
        jnp.stack([wdot(g0, g0)] * 7).astype(acc))[0])
    tol = jnp.maximum(jnp.asarray(abs_tol, acc), rel_tol * res0)
    zero = jnp.zeros((), acc)
    history = jnp.full((max_iter + 1,), jnp.nan, dtype=acc).at[0].set(res0)

    def cond(state):
        _, _, _, _, _, _, _, _, it, res, _ = state
        return (res > tol) & (it < max_iter)

    def body(state):
        x, g, d, h, alpha, beta, alpha_old, beta_old, it, _, hist = state
        it = it + 1
        alpha_old_eff = jnp.where(it % 2 == 1, alpha_old, zero)
        x, g, d = update4b(x, g, d, h, alpha, beta, alpha_old_eff, beta_old)
        h = a_apply(d).astype(dtype)
        s = dots7(g, d, h)
        alpha_old, beta_old = alpha, beta
        alpha = s[6] / s[0]
        res = jnp.sqrt(jnp.maximum(s[3] + 2 * alpha * s[2] + alpha**2 * s[1], 0.0))
        beta = alpha * (s[4] + alpha * s[5]) / s[6]
        return x, g, d, h, alpha, beta, alpha_old, beta_old, it, res, hist.at[it].set(res)

    state = (x_init, g0, jnp.zeros_like(b), jnp.zeros_like(b),
             zero, zero, zero, zero, jnp.asarray(0, jnp.int32), res0, history)
    x, g, d, h, alpha, beta, alpha_old, beta_old, it, res, history = (
        jax.lax.while_loop(cond, body, state))

    # delayed-x exit fixup (solver_cg_optimized.h:254-289): odd iteration
    # counts owe alpha*d; even counts owe the combined two-step update.
    safe_beta_old = jnp.where(beta_old == 0, 1.0, beta_old)
    da = d.astype(acc)
    x_odd = x + alpha * da
    x_even = (x + (alpha + alpha_old / safe_beta_old) * da
              + (alpha_old / safe_beta_old) * (prec_a * g))
    x = jnp.where(it == 0, x, jnp.where(it % 2 == 1, x_odd, x_even))
    return SolveResult(x, it, res, history, res <= tol)
