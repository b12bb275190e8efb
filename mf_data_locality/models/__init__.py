"""Benchmark problem families (CEED bake-off problems).

* :mod:`bp4` — the reference's flagship: 3-component vector Poisson with
  Gauss(p+2) integration (BP3 via ``n_components=1``).
* mass-operator problems (BP1/BP2 analogs) via
  :mod:`mf_data_locality.ops.mass`.
"""

from mf_data_locality.models import bp4  # noqa: F401
