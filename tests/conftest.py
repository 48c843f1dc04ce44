"""Test configuration.

JAX tests run on a virtual 8-device CPU mesh so multi-device sharding paths
are exercised without a GPU; set before jax is imported anywhere.  Tests
marked ``gpu`` need the card: ``JAX_PLATFORMS=cuda`` keeps the GPU for them.
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS") != "cuda":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# entry points under test turn the persistent compile cache on; the tests'
# own small compiles are never worth writing to it
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)


@pytest.fixture
def gpu():
    """Skips unless JAX's first device is a GPU: decided when a test runs,
    never at import.  Run the marked tests on the card with
    ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/ -p no:xdist``."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX platform "
                    f"{jax.devices()[0].platform!r})")
