"""Baseline preconditioned conjugate gradient.

Capability of the ``benchmark_precond`` executable: stock deal.II ``SolverCG``
with ``ReductionControl(100, 1e-15, 1e-8)`` (reference:
``benchmark_precond/bench.cc:4-25``).  This is the *textbook* algorithm — 3
separate reductions and several distinct vector sweeps per iteration — kept
deliberately un-merged as the comparison baseline for the fused solver in
:mod:`cg_merged`.

The whole solve runs on device inside ``lax.while_loop`` (the device analog
of the reference's CPU loop: no host round-trips; the convergence check is a
device scalar).  The preconditioner is the node-blocked Jacobi vector — one
scalar per node, broadcast across components (``diagonal_matrix_blocked.h``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class SolveResult(NamedTuple):
    x: jax.Array
    n_iterations: jax.Array  # int32 scalar
    res_norm: jax.Array  # final (monitored) residual norm
    res_history: jax.Array  # (max_iter + 1,) monitored norms; NaN where unused
    converged: jax.Array  # bool scalar


def _prec_apply(prec: jax.Array, v: jax.Array) -> jax.Array:
    """Node-blocked Jacobi: one diagonal entry per node, all components.

    ``prec`` must broadcast against ``v`` — for (C, n_nodes) vectors pass the
    inverse node diagonal as shape (1, n_nodes) or (n_nodes,).
    """
    return prec * v


def cg_solve(
    a_apply: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    prec: jax.Array,
    x0: jax.Array | None = None,
    max_iter: int = 100,
    abs_tol: float = 1e-15,
    rel_tol: float = 1e-8,
    reduce_scalar: Callable[[jax.Array], jax.Array] | None = None,
    dot_weight: jax.Array | None = None,
) -> SolveResult:
    """Textbook PCG solving A x = b to ``max(abs_tol, rel_tol * ||r0||)``.

    ``a_apply`` must be linear-symmetric-positive-definite on the masked
    subspace; ``b`` of shape (C, n_nodes); ``prec`` the inverse node diagonal,
    broadcastable against ``b``.  Iteration counting matches deal.II's
    ``ReductionControl``:
    the initial residual is "step 0"; each iteration increments by one and is
    checked after updating the residual.

    ``reduce_scalar`` (e.g. a psum) and ``dot_weight`` (owned-DoF weighting)
    support the distributed path; note the textbook algorithm needs one
    reduction per dot product — 3 per iteration vs the merged solver's 1.
    """
    dtype = b.dtype
    # never accumulate dots or the x/r recurrence in bf16 (see cg_merged);
    # only the operator stream p -> Ap stays at the storage dtype
    acc = jnp.float32 if dtype == jnp.bfloat16 else dtype
    if reduce_scalar is None:
        reduce_scalar = lambda s: s  # noqa: E731

    def wdot(a, c):
        a = a.astype(acc)
        c = c.astype(acc)
        local = (jnp.vdot(a, c, precision=jax.lax.Precision.HIGHEST)
                 if dot_weight is None else jnp.sum(a * c * dot_weight))
        return reduce_scalar(local.real.astype(acc))

    x = jnp.zeros_like(b, dtype=acc) if x0 is None else x0.astype(acc)

    r = (b.astype(acc) - a_apply(x.astype(dtype)).astype(acc)
         if x0 is not None else b.astype(acc))
    res0 = jnp.sqrt(wdot(r, r))
    tol = jnp.maximum(jnp.asarray(abs_tol, acc), rel_tol * res0)

    z = _prec_apply(prec.astype(acc), r)
    p = z.astype(dtype)
    rz = wdot(r, z)
    history = jnp.full((max_iter + 1,), jnp.nan, dtype=acc).at[0].set(res0)

    def cond(state):
        _, _, _, _, res, it, _ = state
        return (res > tol) & (it < max_iter)

    def body(state):
        x, r, p, rz, _, it, hist = state
        ap = a_apply(p).astype(dtype)
        alpha = rz / wdot(p, ap)
        x = x + alpha * p.astype(acc)
        r = r - alpha * ap.astype(acc)
        res = jnp.sqrt(wdot(r, r))
        z = _prec_apply(prec.astype(acc), r)
        rz_new = wdot(r, z)
        beta = rz_new / rz
        p = (z + beta * p.astype(acc)).astype(dtype)
        it = it + 1
        return x, r, p, rz_new, res, it, hist.at[it].set(res)

    state = (x, r, p, rz, res0, jnp.asarray(0, jnp.int32), history)
    x, r, p, rz, res, it, history = jax.lax.while_loop(cond, body, state)
    return SolveResult(x, it, res, history, res <= tol)
