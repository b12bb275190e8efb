"""Manufactured-solution convergence: L2 error ~ h^(p+1) (SURVEY.md §4(e)).

Solves -Laplace(u) = f with u = sin(pi x) sin(pi y) sin(pi z) on the unit
cube (undeformed mesh: affine cells, so the geometric error vanishes and the
clean FEM rate is observable; the deformed benchmark mesh uses a trilinear
mapping whose geometry error caps the rate at 2, as in the reference with
MappingQGeneric(1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality.mesh.box import BoxMesh
from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import laplace, rhs
from mf_data_locality.ops.diagonal import compute_inverse_diagonal
from mf_data_locality.solvers import cg_merged


def u_exact(x):
    return (np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
            * np.sin(np.pi * x[..., 2]))[..., None]


def f_source(x):
    return 3 * np.pi**2 * u_exact(x)


def solve_poisson(s, p):
    layout = DofLayout(BoxMesh.from_s(s, deformed=False), p)
    op = laplace.make_operator(layout, dtype=jnp.float64)
    b = rhs.assemble_rhs(layout, f_source)
    prec = compute_inverse_diagonal(layout)[None, :]
    a = lambda u: laplace.vmult(op, u, constrained_identity=False)  # noqa: E731
    res = cg_merged.merged_cg_solve(a, jnp.asarray(b), prec,
                                    max_iter=400, rel_tol=1e-11)
    assert bool(res.converged)
    return layout, np.asarray(res.x)


@pytest.mark.parametrize("p,expected_rate", [(1, 2.0), (2, 3.0)])
def test_l2_convergence_rate(p, expected_rate):
    errors = []
    for s in (3, 6):  # h = 1/2, 1/4
        layout, x = solve_poisson(s, p)
        errors.append(rhs.l2_error(layout, x, u_exact))
    rate = np.log2(errors[0] / errors[1])
    assert rate > expected_rate - 0.35, (errors, rate)


def test_solution_values_reasonable():
    layout, x = solve_poisson(6, 2)
    mid = np.argmin(np.linalg.norm(layout.node_coords - 0.5, axis=1))
    # u(0.5,0.5,0.5) = 1
    assert abs(x[0, mid] - 1.0) < 5e-3


def test_rhs_constant_source_integral():
    """sum(rhs) over free DoFs with f=1 equals volume minus boundary rows."""
    layout = DofLayout(BoxMesh.from_s(3, deformed=False), 2)
    b = rhs.assemble_rhs(layout, lambda x: np.ones(x.shape[:-1] + (1,)),
                         apply_constraints=False)
    # partition of unity: sum_i rhs_i = integral of f = volume = 1
    assert np.isclose(b.sum(), 1.0, atol=1e-12)
