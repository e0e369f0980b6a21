"""Device model tests: the peak table and capacity read from the device."""

import pytest

from radixjoin import engine, hardware


class _FakeDevice:
    def __init__(self, platform, kind, stats=None):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_detect_cpu_backend():
    spec = hardware.spec()  # CPU test mesh -> the CPU entry
    assert spec is hardware.CPU
    assert hardware.device_memory_bytes() == hardware.CPU_MEMORY_BYTES


def test_h100_entry():
    dev = _FakeDevice("gpu", "NVIDIA H100 80GB HBM3")
    spec = hardware.spec(dev)
    assert spec.hbm_gbps == 3350.0
    assert "data sheet" in spec.source


def test_unknown_gpu_kind_raises():
    dev = _FakeDevice("gpu", "Some Future Accelerator", {"bytes_limit": 1})
    with pytest.raises(LookupError, match="Some Future Accelerator"):
        hardware.spec(dev)


def test_capacity_from_memory_stats():
    limit = 60 * hardware.GiB
    dev = _FakeDevice("gpu", "NVIDIA H100 80GB HBM3",
                      {"bytes_limit": limit, "bytes_in_use": 0})
    assert hardware.device_memory_bytes(dev) == limit
    with pytest.raises(LookupError):
        hardware.device_memory_bytes(_FakeDevice("gpu", "x", None))


def test_engine_budget_from_device(monkeypatch):
    monkeypatch.delenv("RJT_HBM_BUDGET_BYTES", raising=False)
    limit = 60 * hardware.GiB
    monkeypatch.setattr(
        hardware, "_device",
        lambda device=None: _FakeDevice(
            "gpu", "NVIDIA H100 80GB HBM3", {"bytes_limit": limit}),
    )
    assert engine._hbm_budget() == limit // 2
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", "12345")
    assert engine._hbm_budget() == 12345
