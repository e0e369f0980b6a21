"""Device model: memory capacity and published peak rates.

The reference encodes its hardware model as compile-time macros in
``include/hardware.h`` (SPC__CORE_COUNT, SPC__LEVEL2_CACHE_SIZE, ...) and
sizes its radix partitions so each build bucket fits L2 (reference
src/execute.cpp:86-92). Here the tier that bounds a join is device
memory, and its size is read from the device itself:
``memory_stats()["bytes_limit"]`` is what the runtime lets this process
allocate. The engine's spill threshold and the host-staged partition
budget derive from it.

Peak rates, which only the roofline harness divides by, come from one
table keyed by ``device_kind``. A device kind missing from the table is an
error, not a default. The CPU entry exists for the test suite
(``platform == "cpu"``); its numbers are tokens, never measurements.
"""

from __future__ import annotations

import dataclasses

GiB = 1 << 30


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    kind: str
    hbm_gbps: float  # published peak memory bandwidth, GB/s
    source: str


#: device_kind -> published peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        "NVIDIA H100 80GB HBM3", 3350.0,
        "NVIDIA H100 SXM data sheet (80 GB HBM3 at 3.35 TB/s)",
    ),
}

#: virtual CPU devices (tests): token numbers, never benched
CPU = DeviceSpec("cpu", 50.0, "token value for CPU test runs")
CPU_MEMORY_BYTES = 8 * GiB


def _device(device=None):
    if device is None:
        import jax

        device = jax.devices()[0]
    return device


def spec(device=None) -> DeviceSpec:
    """Published peaks of ``device`` (default: ``jax.devices()[0]``)."""
    device = _device(device)
    if device.platform == "cpu":
        return CPU
    hit = PEAKS.get(device.device_kind)
    if hit is None:
        raise LookupError(
            f"no published peaks for device kind {device.device_kind!r}; "
            f"add it to radixjoin.hardware.PEAKS with its source"
        )
    return hit


def device_memory_bytes(device=None) -> int:
    """Bytes this process may allocate on ``device``."""
    device = _device(device)
    if device.platform == "cpu":
        return CPU_MEMORY_BYTES
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise LookupError(
            f"device {device} reports no memory limit (memory_stats)"
        )
    return int(stats["bytes_limit"])
