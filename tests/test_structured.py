"""Structured lattice fast path vs general gather/scatter operator."""

import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality.mesh.box import BoxMesh
from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import laplace, laplace_structured as ls


@pytest.mark.parametrize("p", [1, 2, 3])
def test_cellify_overlap_add_adjoint(p):
    """<cellify(u), v> == <u, overlap_add(v)> — exact adjointness per axis."""
    rng = np.random.default_rng(0)
    n = 4 * p + 1
    u = jnp.asarray(rng.normal(size=(2, n, 3)))
    v = jnp.asarray(rng.normal(size=(2, 4, p + 1, 3)))
    cu = ls.cellify(u, 1, p)
    assert cu.shape == (2, 4, p + 1, 3)
    lhs = float(jnp.vdot(cu, v))
    rhs = float(jnp.vdot(u, ls.overlap_add(v, 1, p)))
    assert np.isclose(lhs, rhs, rtol=1e-13)


def test_cellify_values():
    p = 2
    u = jnp.arange(9.0)  # nodes 0..8, nc=4
    c = ls.cellify(u, 0, p)
    expect = np.array([[0, 1, 2], [2, 3, 4], [4, 5, 6], [6, 7, 8]], dtype=float)
    assert np.allclose(np.asarray(c), expect)


def test_overlap_add_values():
    p = 2
    v = jnp.ones((4, 3))
    out = ls.overlap_add(v, 0, p)
    # shared nodes (2,4,6) get two contributions
    expect = np.array([1, 1, 2, 1, 2, 1, 2, 1, 1], dtype=float)
    assert np.allclose(np.asarray(out), expect)


@pytest.mark.parametrize("s,p", [(0, 1), (3, 1), (3, 2), (4, 2), (3, 3), (1, 4), (5, 3)])
def test_structured_matches_general(s, p):
    layout = DofLayout(BoxMesh.from_s(s), p)
    op_g = laplace.make_operator(layout, dtype=jnp.float64)
    op_s = ls.make_structured_operator(layout, dtype=jnp.float64)
    rng = np.random.default_rng(11)
    u = jnp.asarray(rng.normal(size=(3, layout.n_nodes)))
    vg = np.asarray(laplace.vmult(op_g, u))
    vs = np.asarray(ls.to_flat(ls.vmult(op_s, ls.to_lattice(u, layout))))
    scale = np.abs(vg).max()
    assert np.abs(vs - vg).max() < 1e-12 * scale


def test_structured_jit_and_shapes():
    import jax

    layout = DofLayout(BoxMesh.from_s(6), 3)
    op_s = ls.make_structured_operator(layout, dtype=jnp.float32)
    u = jnp.ones((3,) + layout.n_nodes_axis, dtype=jnp.float32)
    f = jax.jit(lambda v: ls.vmult(op_s, v))
    out = f(u)
    assert out.shape == u.shape and out.dtype == jnp.float32


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_structured_f32_matches_f64(p):
    """The f32 operator stays within f32 rounding of the f64 one — the
    tolerance of chip_smoke's on-card precision phase, which a contraction
    run in TF32 (about 1e-3) would fail."""
    import jax

    layout = DofLayout(BoxMesh.from_s(4), p)
    rng = np.random.default_rng(p)
    u = jnp.asarray(rng.normal(size=(3,) + layout.n_nodes_axis))
    apply = jax.jit(ls.vmult)
    v64 = apply(ls.make_structured_operator(layout, dtype=jnp.float64), u)
    v32 = apply(ls.make_structured_operator(layout, dtype=jnp.float32),
                u.astype(jnp.float32))
    assert v32.dtype == jnp.float32
    v64, v32 = np.asarray(v64), np.asarray(v32, np.float64)
    assert np.abs(v32 - v64).max() <= 1e-5 * np.abs(v64).max()
