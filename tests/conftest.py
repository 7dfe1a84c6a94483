"""Test harness: the CPU backend with 8 virtual devices.

Tests run on the CPU (f64 golden math, virtual 8-device meshes for the
distributed paths) unless JAX_PLATFORMS names another platform.  Tests
that need the card take the `gpu` fixture and carry the `gpu` marker; they
skip on the CPU (run them with JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/), and chip_smoke.py runs the same checks on the card.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")
