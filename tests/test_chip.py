"""Checks that need the GPU (marker ``chip``); they skip without one.

On a machine with a card, from the repository root::

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/test_chip.py

``chip_smoke.py`` covers the same ground at full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mf_data_locality.mesh.box import BoxMesh
from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.models import bp4
from mf_data_locality.ops import laplace_structured as ls


@pytest.mark.chip
def test_f32_operator_is_not_tf32_on_card(gpu):
    """An f32 contraction run in TF32 would miss f64 by about 1e-3."""
    layout = DofLayout(BoxMesh.from_s(12), 4)
    u = jnp.asarray(np.random.default_rng(0).normal(
        size=(3,) + layout.n_nodes_axis))
    apply = jax.jit(ls.vmult)
    v64 = np.asarray(apply(ls.make_structured_operator(
        layout, dtype=jnp.float64), u))
    v32 = np.asarray(apply(ls.make_structured_operator(
        layout, dtype=jnp.float32), u.astype(jnp.float32)), np.float64)
    assert np.abs(v32 - v64).max() <= 1e-5 * np.abs(v64).max()


@pytest.mark.chip
def test_merged_matches_baseline_on_card(gpu):
    problem = bp4.build(9, 2, dtype=jnp.float64)
    rm = bp4.solve_merged(problem)
    rb = bp4.solve_baseline(problem)
    assert bool(rm.converged) and bool(rb.converged)
    assert int(rm.n_iterations) == int(rb.n_iterations)
