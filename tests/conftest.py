"""Test config: CPU backend with 8 virtual devices by default.

Must run before jax initializes a backend (SURVEY.md §7: parity tests run on
the JAX CPU backend; sharding tests use a virtual 8-device mesh). Tests
marked ``gpu`` need an NVIDIA GPU: run them on one with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``; elsewhere they skip.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a ``gpu``-marked test unless JAX's first device is a GPU —
    decided here, when the test runs, never while modules are imported."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU; JAX found "
                        f"{jax.devices()[0].platform}")
