"""Unit tests for quadrature rules and 1D Lagrange operator matrices."""

import numpy as np
import pytest

from mf_data_locality.ops import lagrange, quadrature


@pytest.mark.parametrize("n", range(1, 14))
def test_gauss_exactness(n):
    x, w = quadrature.gauss(n)
    assert np.isclose(w.sum(), 1.0, atol=1e-14)
    for k in range(2 * n):  # exact through degree 2n-1
        exact = 1.0 / (k + 1)
        assert np.isclose((w * x**k).sum(), exact, atol=1e-13), k


@pytest.mark.parametrize("n", range(2, 14))
def test_gauss_lobatto_exactness(n):
    x, w = quadrature.gauss_lobatto(n)
    assert np.isclose(x[0], 0.0) and np.isclose(x[-1], 1.0)
    assert np.isclose(w.sum(), 1.0, atol=1e-14)
    for k in range(2 * n - 2):  # exact through degree 2n-3
        exact = 1.0 / (k + 1)
        assert np.isclose((w * x**k).sum(), exact, atol=1e-13), k


def test_gll_nodes_symmetric():
    for p in range(1, 12):
        nodes = quadrature.gll_nodes(p)
        assert nodes.shape == (p + 1,)
        assert np.allclose(nodes + nodes[::-1], 1.0, atol=1e-14)
        assert np.all(np.diff(nodes) > 0)


@pytest.mark.parametrize("p", range(1, 12))
def test_lagrange_cardinality_and_partition_of_unity(p):
    nodes = quadrature.gll_nodes(p)
    vals = lagrange.lagrange_values(nodes, nodes)
    assert np.allclose(vals, np.eye(p + 1), atol=1e-12)
    pts = np.linspace(0, 1, 33)
    vals = lagrange.lagrange_values(nodes, pts)
    assert np.allclose(vals.sum(axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("p", range(1, 12))
def test_lagrange_derivatives_exact_for_polynomials(p):
    nodes = quadrature.gll_nodes(p)
    pts = np.linspace(0, 1, 17)
    der = lagrange.lagrange_derivatives(nodes, pts)
    for k in range(p + 1):
        u = nodes**k
        du = der @ u
        exact = k * pts ** max(k - 1, 0) if k > 0 else np.zeros_like(pts)
        assert np.allclose(du, exact, atol=1e-10), k


@pytest.mark.parametrize("p,q", [(1, 3), (2, 4), (3, 5), (4, 6), (5, 7), (6, 8)])
def test_collocation_gradient_factorization(p, q):
    """grad-at-q == D_col @ (S @ u): the factorization the hot kernel relies on.

    (reference computes gradients as collocation derivatives of interpolated
    values, poisson_operator.h:552-555 — identical only because interpolation
    lands in the degree<=q-1 collocation space.)
    """
    shape = lagrange.make_shape(p, q)
    assert np.allclose(shape.d_col @ shape.values, shape.grads, atol=1e-11)


def test_gll_shape_is_collocation():
    for p in range(1, 8):
        s = lagrange.make_shape_gll(p)
        assert np.allclose(s.values, np.eye(p + 1), atol=1e-12)
        assert np.allclose(s.d_col, s.d_nod, atol=1e-12)


@pytest.mark.parametrize("p,q", [(2, 4), (4, 6)])
def test_mass_and_stiffness_1d(p, q):
    """1D sanity: S^T diag(w) S and S'^T diag(w) S' reproduce exact integrals."""
    shape = lagrange.make_shape(p, q)
    M = shape.values.T @ (shape.q_weights[:, None] * shape.values)
    K = shape.grads.T @ (shape.q_weights[:, None] * shape.grads)
    nodes = shape.nodes
    for a in range(p + 1):
        for b in range(p + 1):
            # integrate l_a l_b and l_a' l_b' with a huge Gauss rule
            xs, ws = quadrature.gauss(2 * p + 4)
            la = lagrange.lagrange_values(nodes, xs)[:, a]
            lb = lagrange.lagrange_values(nodes, xs)[:, b]
            da = lagrange.lagrange_derivatives(nodes, xs)[:, a]
            db = lagrange.lagrange_derivatives(nodes, xs)[:, b]
            assert np.isclose(M[a, b], (ws * la * lb).sum(), atol=1e-12)
            assert np.isclose(K[a, b], (ws * da * db).sum(), atol=1e-10)
