"""Solver tests: convergence, baseline-vs-merged parity, delayed-x algebra.

SURVEY.md §4(c): merged-CG iterates comparable against textbook PCG in f64;
identical iteration counts between the two paths (the reference's own
invariant — both executables solve the identical system, so itCG must match).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality.models import bp4
from mf_data_locality.ops import laplace
from mf_data_locality.solvers import cg, cg_merged


@pytest.fixture(scope="module")
def problem():
    return bp4.build(s=3, degree=2, dtype=jnp.float64)


def true_residual(problem, x):
    r = problem.b - problem.a_apply_full(x)
    return float(jnp.linalg.norm(r) / jnp.linalg.norm(problem.b))


def test_baseline_cg_converges(problem):
    res = bp4.solve_baseline(problem)
    assert bool(res.converged)
    assert true_residual(problem, res.x) < 2e-8


def test_merged_cg_converges(problem):
    res = bp4.solve_merged(problem)
    assert bool(res.converged)
    assert true_residual(problem, res.x) < 2e-8


def test_merged_matches_baseline(problem):
    """Iteration counts identical; solutions and residual histories agree."""
    rb = bp4.solve_baseline(problem)
    rm = bp4.solve_merged(problem)
    assert int(rb.n_iterations) == int(rm.n_iterations)
    nb = np.asarray(rb.res_history)
    nm = np.asarray(rm.res_history)
    k = int(rb.n_iterations)
    assert np.allclose(nb[: k + 1], nm[: k + 1], rtol=1e-6)
    xb, xm = np.asarray(rb.x), np.asarray(rm.x)
    assert np.abs(xb - xm).max() < 1e-8 * np.abs(xb).max()


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 10])
def test_delayed_x_fixup_at_truncation(problem, k):
    """Force exit at iteration k (odd and even): merged x must equal textbook x_k.

    This pins the delayed-update algebra (solver_cg_optimized.h:254-289) at
    both exit parities.
    """
    rb = bp4.solve_baseline(problem, max_iter=k, rel_tol=0.0)
    rm = bp4.solve_merged(problem, max_iter=k, rel_tol=0.0)
    assert int(rb.n_iterations) == int(rm.n_iterations) == k
    xb, xm = np.asarray(rb.x), np.asarray(rm.x)
    scale = max(np.abs(xb).max(), 1e-30)
    assert np.abs(xb - xm).max() < 1e-10 * scale


def test_monitored_residual_is_true_residual(problem):
    """The sigma-trick residual estimate equals ||b - A x_k|| in exact arithmetic."""
    for k in (3, 6):
        rm = bp4.solve_merged(problem, max_iter=k, rel_tol=0.0)
        tr = float(jnp.linalg.norm(problem.b - problem.a_apply_full(rm.x)))
        assert np.isclose(float(rm.res_norm), tr, rtol=1e-8)


def test_zero_rhs_short_circuits(problem):
    zero_b = jnp.zeros_like(problem.b)
    res = cg_merged.merged_cg_solve(problem.a_apply, zero_b, problem.inv_diag)
    assert int(res.n_iterations) == 0
    assert float(jnp.abs(res.x).max()) == 0.0


def test_solution_matches_direct_solve():
    """End-to-end vs dense LU on a tiny problem (independent path)."""
    problem = bp4.build(s=2, degree=2, dtype=jnp.float64)
    K = laplace.assemble_dense(problem.layout)  # constrained scalar block
    b = np.asarray(problem.b).reshape(3, -1)
    expect = np.stack([np.linalg.solve(K, b[c]) for c in range(3)], axis=0)
    rm = bp4.solve_merged(problem, rel_tol=1e-12)
    got = np.asarray(rm.x).reshape(3, -1)
    assert np.abs(got - expect).max() < 1e-9 * np.abs(expect).max()


def test_iteration_counts_reasonable(problem):
    """BP4 with blocked-Jacobi should converge well under the 100-iter cap."""
    res = bp4.solve_merged(problem)
    assert 5 < int(res.n_iterations) < 100


def test_merged_cg_x0_start():
    """Nonzero x0: g0 = A x0 - b (solver_cg_optimized.h:221-228)."""
    prob = bp4.build(s=4, degree=2, dtype=jnp.float64, backend="structured")
    r_ref = bp4.solve_merged(prob, rel_tol=1e-10)
    rng = np.random.default_rng(3)
    # constraint-consistent start: zero on Dirichlet DoFs (the reference
    # passes vectors with constraints already applied, benchmark.h:170-176)
    free = ~prob.layout.boundary_node_mask
    x0 = jnp.asarray(rng.standard_normal(prob.b.shape) * 0.1 * free[None, :])
    r_x0 = cg_merged.merged_cg_solve(prob.a_apply, prob.b, prob.inv_diag,
                                     x0=x0, rel_tol=1e-10)
    assert bool(r_x0.converged)
    # same linear system -> same solution to solver tolerance
    err = float(jnp.max(jnp.abs(r_x0.x - r_ref.x)))
    scale = float(jnp.max(jnp.abs(r_ref.x)))
    assert err < 1e-7 * scale
    # warm start from the exact solution: the initial residual must reflect
    # g = A x0 - b ~ 0 (tolerance stays RELATIVE to it, ReductionControl
    # semantics, so the iteration count need not be small)
    r_warm = cg_merged.merged_cg_solve(prob.a_apply, prob.b, prob.inv_diag,
                                       x0=r_ref.x, rel_tol=1e-8)
    res0_cold = float(r_ref.res_history[0])
    res0_warm = float(r_warm.res_history[0])
    assert res0_warm < 1e-8 * res0_cold


def test_baseline_cg_x0_matches_merged_x0():
    prob = bp4.build(s=4, degree=2, dtype=jnp.float64, backend="structured")
    rng = np.random.default_rng(4)
    free = ~prob.layout.boundary_node_mask
    x0 = jnp.asarray(rng.standard_normal(prob.b.shape) * 0.1 * free[None, :])
    r_b = cg.cg_solve(prob.a_apply_full, prob.b, prob.inv_diag, x0=x0,
                      rel_tol=1e-10)
    r_m = cg_merged.merged_cg_solve(prob.a_apply, prob.b, prob.inv_diag,
                                    x0=x0, rel_tol=1e-10)
    assert bool(r_b.converged) and bool(r_m.converged)
    assert int(r_b.n_iterations) == int(r_m.n_iterations)


def test_f32_iteration_parity_vs_f64():
    """f32 iteration counts of the structured path track f64 at a convergent
    size."""
    for p, s in [(2, 6), (3, 5)]:
        r64 = bp4.solve_merged(bp4.build(s=s, degree=p, dtype=jnp.float64),
                               rel_tol=1e-8)
        r32 = bp4.solve_merged(bp4.build(s=s, degree=p, dtype=jnp.float32),
                               rel_tol=1e-8)
        assert bool(r64.converged) and bool(r32.converged)
        it64, it32 = int(r64.n_iterations), int(r32.n_iterations)
        assert abs(it64 - it32) <= max(1, round(0.03 * it64)), (it64, it32)
