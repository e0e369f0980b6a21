"""Checks that need the card: every gather on the device path, compiled
for the GPU, against numpy (the kernels phase of chip_smoke.py at reduced
size). Skipped where JAX has no GPU."""

import pytest

import jax


@pytest.mark.gpu
def test_device_gathers_exact_on_gpu(gpu_device):
    import chip_smoke

    with jax.default_device(gpu_device):
        chip_smoke.phase_kernels(
            n=1 << 20, windows=(128, 4096, 1 << 20),
            decode_rows=(1 << 18) + 123,
        )
