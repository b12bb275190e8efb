"""Functional-transform capabilities: autodiff and vmap through the stack.

These have no counterpart in the C++ reference — they come from building
on JAX: the operator is a pure function, so differentiation,
batching and jit composition are free.  Pinned here as part of the public
contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality.models import bp4
from mf_data_locality.solvers import cg_merged


@pytest.fixture(scope="module")
def problem():
    return bp4.build(s=2, degree=2, dtype=jnp.float64, backend="general")


def test_vjp_is_transpose(problem):
    """The operator is symmetric, so vjp(A)(y) == A y."""
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.normal(size=problem.b.shape))
    y = jnp.asarray(rng.normal(size=problem.b.shape))
    a = problem.a_apply
    _, vjp = jax.vjp(a, u)
    (aty,) = vjp(y)
    ay = a(y)
    assert np.abs(np.asarray(aty - ay)).max() < 1e-12


def test_jvp_linearity(problem):
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.normal(size=problem.b.shape))
    du = jnp.asarray(rng.normal(size=problem.b.shape))
    _, tangent = jax.jvp(problem.a_apply, (u,), (du,))
    assert np.abs(np.asarray(tangent - problem.a_apply(du))).max() < 1e-12


def test_grad_of_energy(problem):
    """grad of the quadratic energy 0.5 u^T A u - b^T u is A u - b."""
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.normal(size=problem.b.shape))

    def energy(v):
        return 0.5 * jnp.vdot(v, problem.a_apply(v)) - jnp.vdot(problem.b, v)

    g = jax.grad(energy)(u)
    expect = problem.a_apply(u) - problem.b
    assert np.abs(np.asarray(g - expect)).max() < 1e-11


def test_vmap_batched_solves(problem):
    """vmap over RHS batches the whole merged-CG solve."""
    rng = np.random.default_rng(3)
    mask = np.asarray(problem.op.unconstrained)[None, :]
    bs = jnp.asarray(rng.normal(size=(3,) + problem.b.shape) * mask)

    def solve_one(b):
        res = cg_merged.merged_cg_solve(problem.a_apply, b,
                                        problem.inv_diag, rel_tol=1e-10)
        return res.x

    batched = jax.vmap(solve_one)(bs)
    for i in range(3):
        single = solve_one(bs[i])
        assert np.abs(np.asarray(batched[i] - single)).max() \
            < 1e-9 * max(np.abs(np.asarray(single)).max(), 1e-30)
