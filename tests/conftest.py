"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device hardware is not available in CI; sharding tests use
xla_force_host_platform_device_count per the scaling-book recipe. The
platform is pinned to the CPU before the first backend use, so the suite
computes the same everywhere, whether or not the host has a GPU. The GPU
paths run through chip_smoke.py on a GPU host.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running; the tier-1 run deselects these")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips inside the `gpu` fixture "
        "when JAX's default backend is not one")


@pytest.fixture
def gpu():
    """The GPU devices, or a skip. Decided here, at run time, never at
    import or collection, so that every xdist worker collects alike."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run chip_smoke.py on a GPU host")
    return jax.devices()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
