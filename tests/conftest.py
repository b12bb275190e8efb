"""Test configuration: run the suite on CPU with 8 virtual devices.

The multi-device tests exercise the same ``shard_map`` programs that run on
several GPUs ("multi-node testing without a cluster" — the analog of the
reference's MPI oversubscription, see SURVEY.md §4).  float64 is enabled so
operator/solver kernels can be validated at full precision.

``JAX_PLATFORMS`` picks another backend when it is set: the card-only tests
(marker ``chip``, ``tests/test_chip.py``) run with ``JAX_PLATFORMS=cuda``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX has {dev.platform}")
    return dev
