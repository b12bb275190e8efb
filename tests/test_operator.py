"""Matrix-free operator vs dense assembly, symmetry and null-space tests.

SURVEY.md §4(b): matvec vs dense-assembled stiffness on tiny meshes, symmetry
x.(Ay) == y.(Ax), and null space (constants map to ~0 without constraints).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality.mesh.box import BoxMesh
from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import laplace


def make(s, p, dtype=jnp.float64):
    layout = DofLayout(BoxMesh.from_s(s), p)
    return layout, laplace.make_operator(layout, dtype=dtype)


@pytest.mark.parametrize("s,p", [(0, 1), (1, 1), (3, 1), (0, 2), (1, 2), (3, 2),
                                 (0, 3), (1, 3), (0, 4)])
def test_vmult_matches_dense(s, p):
    layout, op = make(s, p)
    K = laplace.assemble_dense(layout)  # scalar block, constraints applied
    rng = np.random.default_rng(42)
    u = rng.normal(size=(3, layout.n_nodes))
    v = np.asarray(laplace.vmult(op, jnp.asarray(u)))
    # dense vector operator acts per component with the same scalar block
    expect = np.stack([K @ u[c] for c in range(3)], axis=0)
    scale = np.abs(expect).max()
    assert np.abs(v - expect).max() < 1e-11 * max(scale, 1.0)


@pytest.mark.parametrize("s,p", [(3, 2), (1, 4)])
def test_operator_symmetry(s, p):
    layout, op = make(s, p)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(3, layout.n_nodes)))
    y = jnp.asarray(rng.normal(size=(3, layout.n_nodes)))
    ax = laplace.vmult(op, x)
    ay = laplace.vmult(op, y)
    lhs = float(jnp.vdot(y, ax))
    rhs = float(jnp.vdot(x, ay))
    assert np.isclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("s,p", [(3, 1), (3, 3), (2, 2)])
def test_nullspace_constants(s, p):
    """Without constraints, K annihilates constant fields in every component."""
    layout, op = make(s, p)
    u = jnp.ones((3, layout.n_nodes), dtype=jnp.float64) * jnp.asarray([1.0, -2.0, 0.5])[:, None]
    v = laplace.apply_cells(op, u)
    assert float(jnp.abs(v).max()) < 1e-11


@pytest.mark.parametrize("s,p", [(3, 2)])
def test_linear_field_exact_gradient(s, p):
    """K applied to a linear field equals boundary terms only (interior rows ~ 0

    modulo quadrature): the weak Laplacian of u = a.x vanishes for interior
    test functions on any mesh (integration by parts, grad constant)."""
    layout, op = make(s, p)
    a = np.array([0.3, -0.7, 1.1])
    lin = layout.node_coords @ a  # scalar linear field
    u = jnp.asarray(np.stack([lin, 2 * lin, -lin], axis=0))
    v = np.asarray(laplace.apply_cells(op, u))
    interior = ~layout.boundary_node_mask
    assert np.abs(v[:, interior]).max() < 1e-10


def test_positive_definite_on_unconstrained():
    layout, op = make(2, 2)
    rng = np.random.default_rng(3)
    mask = np.asarray(op.unconstrained)[None, :]
    for _ in range(5):
        u = rng.normal(size=(3, layout.n_nodes)) * mask
        if np.abs(u).max() == 0:
            continue
        quad = float(jnp.vdot(jnp.asarray(u), laplace.vmult(op, jnp.asarray(u))))
        assert quad > 0


def test_constrained_identity_matches_reference_vmult():
    layout, op = make(1, 2)
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.normal(size=(3, layout.n_nodes)))
    full = np.asarray(laplace.vmult(op, u, constrained_identity=True))
    bc = layout.boundary_node_mask
    assert np.allclose(full[:, bc], np.asarray(u)[:, bc])  # dst[constrained] = src


def test_vmult_on_randomly_jittered_mesh():
    """General-mesh capability: random interior vertex perturbations (valid
    but non-smooth hexes) still match dense assembly — the operator is not
    specialized to the benchmark manifold."""
    mesh = BoxMesh.from_s(3, deformed=False)
    rng = np.random.default_rng(123)
    lat = mesh.vertex_lattice.copy()
    jitter = rng.uniform(-0.12, 0.12, size=lat.shape) * mesh.spacing
    jitter[0] = jitter[-1] = 0.0
    jitter[:, 0] = jitter[:, -1] = 0.0
    jitter[:, :, 0] = jitter[:, :, -1] = 0.0
    mesh.__dict__["vertex_lattice"] = lat + jitter  # override cached geometry

    layout = DofLayout(mesh, 2)
    op = laplace.make_operator(layout, dtype=jnp.float64)
    K = laplace.assemble_dense(layout)
    u = rng.normal(size=(3, layout.n_nodes))
    v = np.asarray(laplace.vmult(op, jnp.asarray(u)))
    expect = np.stack([K @ u[c] for c in range(3)], axis=0)
    assert np.abs(v - expect).max() < 1e-11 * np.abs(expect).max()

    # the structured lattice path agrees on the same jittered mesh
    from mf_data_locality.ops import laplace_structured as ls

    op_s = ls.make_structured_operator(layout, dtype=jnp.float64)
    ul = jnp.asarray(u).reshape((3,) + layout.n_nodes_axis)
    vs = np.asarray(ls.vmult(op_s, ul)).reshape(3, -1)
    assert np.abs(vs - expect).max() < 1e-11 * np.abs(expect).max()
