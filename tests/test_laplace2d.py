"""2D operator path vs dense assembly (reference dim==2 capability)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality.ops import laplace2d as l2


@pytest.mark.parametrize("nc,p", [((2, 2), 1), ((3, 2), 2), ((2, 3), 3), ((4, 4), 2)])
def test_vmult2d_matches_dense(nc, p):
    mesh = l2.BoxMesh2D(n_cells_axis=nc, spacing=1.0 / max(nc))
    layout = l2.DofLayout2D(mesh, p)
    op = l2.make_operator2d(layout)
    K = l2.assemble_dense2d(layout)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(2, layout.n_nodes))
    v = np.asarray(l2.vmult2d(op, jnp.asarray(u)))
    expect = np.stack([K @ u[c] for c in range(2)])
    assert np.abs(v - expect).max() < 1e-11 * np.abs(expect).max()


def test_vmult2d_symmetry_and_nullspace():
    mesh = l2.BoxMesh2D(n_cells_axis=(3, 3), spacing=1 / 3)
    layout = l2.DofLayout2D(mesh, 2)
    op = l2.make_operator2d(layout)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, layout.n_nodes)))
    y = jnp.asarray(rng.normal(size=(2, layout.n_nodes)))
    assert np.isclose(float(jnp.vdot(y, l2.vmult2d(op, x))),
                      float(jnp.vdot(x, l2.vmult2d(op, y))), rtol=1e-12)
    # constants in the nullspace (without constraints/mask)
    ones = jnp.ones((2, layout.n_nodes))
    nc, nloc = op.gather.shape
    u_loc = ones[:, op.gather].reshape(2, nc, p1 := layout.degree + 1, p1)
    v_loc = l2.local_apply2d(op, u_loc)
    assert float(jnp.abs(v_loc).max()) < 1e-12


def test_2d_cg_solve():
    from mf_data_locality.solvers import cg_merged

    mesh = l2.BoxMesh2D(n_cells_axis=(8, 8), spacing=1 / 8)
    layout = l2.DofLayout2D(mesh, 2)
    op = l2.make_operator2d(layout)
    b = np.where(layout.boundary_node_mask, 0.0,
                 np.arange(layout.n_nodes) % 8.0)[None, :]
    prec = jnp.ones((1, layout.n_nodes))  # identity preconditioner
    a = lambda u: l2.vmult2d(op, u, constrained_identity=False)  # noqa: E731
    res = cg_merged.merged_cg_solve(a, jnp.asarray(b), prec, max_iter=300)
    assert bool(res.converged)
    true_res = float(jnp.linalg.norm(jnp.asarray(b) - l2.vmult2d(op, res.x))
                     / jnp.linalg.norm(jnp.asarray(b)))
    assert true_res < 2e-8
