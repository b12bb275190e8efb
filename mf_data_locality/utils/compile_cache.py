"""Where JAX keeps its persistent compilation cache.

Every entry point (``bench.py``, ``benchmark.main``, ``chip_smoke.py``) calls
:func:`enable` once, before its first compilation; no other code sets a cache
directory.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Turn on the persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself, and
    nothing is changed here.  Otherwise the cache is ``<repo>/.jax_cache`` —
    a fixed path, so later runs from the same checkout find what earlier
    ones compiled.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
