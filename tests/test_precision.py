"""Every contraction on the main path asks for HIGHEST precision.

At default precision an f32 ``dot_general`` may run in TF32 on the GPU
(about 3 decimal digits): an accuracy drop that would read as a speed-up.
The lowered StableHLO records each ``dot_general``'s precision, and the
lowering is the same whatever the backend, so this is checked on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from mf_data_locality.models import bp4


def _dot_generals(fn, *args) -> list[str]:
    text = jax.jit(fn).lower(*args).as_text()
    return [ln.strip() for ln in text.splitlines() if "dot_general" in ln]


@pytest.mark.parametrize("case", ["structured", "general", "baseline_cg",
                                  "merged_cg"])
def test_f32_contractions_pin_highest(case):
    backend = "general" if case == "general" else "structured"
    problem = bp4.build(3, 2, dtype=jnp.float32, backend=backend)
    if case in ("structured", "general"):
        dots = _dot_generals(problem.a_apply_full, problem.b)
    else:
        solve = {"baseline_cg": bp4.solve_baseline,
                 "merged_cg": bp4.solve_merged}[case]
        dots = _dot_generals(
            lambda b: solve(dataclasses.replace(problem, b=b), max_iter=2),
            problem.b)
        # the CG dot products themselves: full contractions to a scalar
        assert any("-> tensor<f32>" in d for d in dots), dots
    assert dots
    for d in dots:
        assert "precision = [HIGHEST, HIGHEST]" in d, d
