"""Closed-form GLL diagonal vs brute-force dense GLL assembly."""

import numpy as np
import pytest

from mf_data_locality.mesh.box import BoxMesh
from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import diagonal, laplace


@pytest.mark.parametrize("s,p", [(0, 1), (1, 2), (3, 2), (0, 3), (1, 3), (0, 4), (0, 5)])
def test_inverse_diagonal_matches_dense_gll(s, p):
    layout = DofLayout(BoxMesh.from_s(s), p)
    K = laplace.assemble_dense(layout, rule="gll", apply_constraints=False)
    expect = np.diag(K).copy()
    bc = layout.boundary_node_mask
    expect[bc] = 1.0
    got = 1.0 / np.asarray(diagonal.compute_inverse_diagonal(layout))
    assert np.allclose(got, expect, rtol=1e-11)


def test_diagonal_positive():
    layout = DofLayout(BoxMesh.from_s(4), 3)
    d = np.asarray(diagonal.compute_inverse_diagonal(layout))
    assert np.all(d > 0)
