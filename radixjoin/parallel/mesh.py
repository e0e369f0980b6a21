"""Device mesh helpers.

The distributed join runs SPMD over a 1-D mesh axis (``'shards'``): every
base-table shard lives on one device, the radix shuffle is an all-to-all
over the axis, and histograms reduce with psum. A flat 1-D axis suits a
GPU host whose cards are joined all to all (NVLink): XLA lowers the
collectives to NCCL, and across processes the same code runs unchanged
with the axis spanning every process's devices.

The reference has no distribution at all (single process + OpenMP,
SURVEY.md §2 checklist); this layer is the new capability mandated by
BASELINE.json's north star.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "shards"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (SHARD_AXIS,))


def shard_axis(mesh: Mesh) -> NamedSharding:
    """Sharding that splits axis 0 of an array across the mesh."""
    return NamedSharding(mesh, P(SHARD_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
