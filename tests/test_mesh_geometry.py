"""Tests for the manifold, box mesh and trilinear geometry."""

import numpy as np
import pytest

from mf_data_locality.mesh import box, manifold
from mf_data_locality.ops import geometry


def test_manifold_roundtrip():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, size=(200, 3))
    fwd = manifold.push_forward(pts)
    back = manifold.pull_back(fwd)
    assert np.allclose(back, pts, atol=1e-10)


def test_manifold_matches_formula():
    p = np.array([0.3, 0.4, 0.5])
    out = manifold.push_forward(p)
    sinval = 0.1 * np.sin(np.pi * 0.3) * np.sin(np.pi * 0.4) * np.sin(np.pi * 0.5)
    assert np.allclose(out, p + sinval, atol=1e-15)


@pytest.mark.parametrize("s", range(0, 8))
def test_box_mesh_cell_count(s):
    m = box.BoxMesh.from_s(s)
    assert m.n_cells == 2**s
    ncz, ncy, ncx = m.n_cells_axis
    # extents: first s%3 coordinates reach 2, others 1 (benchmark.h:67-74)
    rem = s % 3
    assert np.isclose(ncx * m.spacing, 2.0 if rem >= 1 else 1.0)
    assert np.isclose(ncy * m.spacing, 2.0 if rem >= 2 else 1.0)
    assert np.isclose(ncz * m.spacing, 1.0)


def test_box_mesh_vertices_deformed():
    m = box.BoxMesh.from_s(3)  # 2x2x2 cells on the unit cube
    lat = m.vertex_lattice
    # boundary vertices have at least one coordinate at 0/1 -> sin factor 0 -> undeformed
    assert np.allclose(lat[0, :, :, :][..., 2], 0.0)  # z=0 plane stays flat
    assert np.allclose(lat[-1, :, :, :][..., 2], 1.0)
    center = lat[1, 1, 1]  # lattice point (0.5, 0.5, 0.5)
    expect = 0.5 + 0.1 * np.sin(np.pi * 0.5) ** 3
    assert np.allclose(center, expect)


def test_cell_vertices_match_connectivity():
    m = box.BoxMesh.from_s(4)
    via_conn = m.vertices[m.cells]  # (n_cells, 8, 3)
    assert np.allclose(via_conn, m.cell_vertices)


def test_trilinear_map_reproduces_corners():
    m = box.BoxMesh.from_s(5)
    c = geometry.trilinear_coefficients(m.cell_vertices)
    for v in range(8):
        uvw = np.array([v & 1, (v >> 1) & 1, (v >> 2) & 1], dtype=np.float64)
        mapped = geometry.map_points(c, uvw)
        assert np.allclose(mapped, m.cell_vertices[:, v, :], atol=1e-13)


def test_jacobian_matches_finite_differences():
    m = box.BoxMesh.from_s(6)
    c = geometry.trilinear_coefficients(m.cell_vertices)[:5]  # few cells
    rng = np.random.default_rng(1)
    uvw = rng.uniform(0.1, 0.9, size=(7, 3))
    J = geometry.jacobian(c[:, None], uvw[None, :])  # (5, 7, 3, 3)
    eps = 1e-6
    for e in range(3):
        dp = uvw.copy(); dp[:, e] += eps
        dm = uvw.copy(); dm[:, e] -= eps
        fd = (geometry.map_points(c[:, None], dp[None]) -
              geometry.map_points(c[:, None], dm[None])) / (2 * eps)
        assert np.allclose(J[..., :, e], fd, atol=1e-8)


def test_invert_3x3():
    rng = np.random.default_rng(2)
    mats = rng.normal(size=(50, 3, 3)) + 3 * np.eye(3)
    inv, det = geometry.invert_3x3(mats)
    assert np.allclose(det, np.linalg.det(mats), atol=1e-10)
    assert np.allclose(inv, np.linalg.inv(mats), atol=1e-10)


def test_jacobian_det_positive_on_benchmark_mesh():
    for s in (3, 6):
        m = box.BoxMesh.from_s(s)
        c = geometry.trilinear_coefficients(m.cell_vertices)
        pts = np.random.default_rng(3).uniform(0, 1, size=(4, 3))
        J = geometry.jacobian(c[:, None], pts[None])
        _, det = geometry.invert_3x3(J)
        assert np.all(det > 0)
