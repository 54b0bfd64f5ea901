"""Test configuration: force the CPU backend with 8 virtual devices, so the
sharding tests run without accelerators. What needs the GPU is checked by
``chip_smoke.py`` on the card, not by this suite."""
import os

# Must happen before jax initializes a backend.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)

