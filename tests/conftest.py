"""Test configuration: the CPU backend with 8 virtual devices.

Multi-device sharding tests run on a virtual 8-device CPU mesh
(xla_force_host_platform_device_count). Must run before the first jax
import. Tests that need a GPU carry the ``gpu`` marker and skip inside the
``gpu_device`` fixture where there is none; on a GPU host they run with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

import pytest

_GPU_RUN = os.environ.get("JAX_PLATFORMS") in ("cuda", "gpu")
if not _GPU_RUN:
    # both the env var and the live jax config are set before any
    # backend initializes, whatever the environment selects
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not _GPU_RUN:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda on a GPU host")
    return gpus[0]
