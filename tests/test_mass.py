"""Mass operator (BP1/BP2 family) validation."""

import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality.mesh.box import BoxMesh
from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import lagrange, mass


def dense_mass(layout, n_q=None):
    """Independent dense assembly of the scalar mass matrix."""
    p = layout.degree
    q = n_q or p + 2
    shape = lagrange.make_shape(p, q)
    nloc = (p + 1) ** 3
    V = shape.values
    phi = np.zeros((nloc, q**3))
    a = 0
    for k in range(p + 1):
        for j in range(p + 1):
            for i in range(p + 1):
                phi[a] = np.einsum("c,b,a->cba", V[:, k], V[:, j],
                                   V[:, i]).reshape(-1)
                a += 1
    op = mass.make_mass_operator(layout, dtype=jnp.float64)
    detw = np.asarray(op.detw)
    M_loc = np.einsum("aq,nq,bq->nab", phi, detw, phi)
    n = layout.n_nodes
    M = np.zeros((n, n))
    for c, idx in enumerate(layout.gather_map):
        M[np.ix_(idx, idx)] += M_loc[c]
    return M


@pytest.mark.parametrize("s,p", [(1, 1), (3, 2), (0, 3)])
def test_mass_matches_dense(s, p):
    layout = DofLayout(BoxMesh.from_s(s), p)
    op = mass.make_mass_operator(layout, dtype=jnp.float64)
    M = dense_mass(layout)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(3, layout.n_nodes))
    v = np.asarray(mass.apply_cells(op, jnp.asarray(u)))
    expect = np.stack([M @ u[c] for c in range(3)])
    assert np.abs(v - expect).max() < 1e-12 * np.abs(expect).max()


def test_mass_total_measure():
    """1^T M 1 = volume of the (deformed) domain = 2^(s%3)."""
    layout = DofLayout(BoxMesh.from_s(4), 2)
    op = mass.make_mass_operator(layout, dtype=jnp.float64)
    ones = jnp.ones((1, layout.n_nodes))
    v = mass.apply_cells(op, ones)
    assert np.isclose(float(v.sum()), 2.0, atol=1e-12)


def test_mass_spd():
    layout = DofLayout(BoxMesh.from_s(2), 2)
    op = mass.make_mass_operator(layout, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    for _ in range(3):
        u = jnp.asarray(rng.normal(size=(1, layout.n_nodes)))
        assert float(jnp.vdot(u, mass.apply_cells(op, u))) > 0
