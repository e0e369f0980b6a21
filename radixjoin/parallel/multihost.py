"""Multi-host (multi-process) execution support.

The reference is strictly single-process (SURVEY.md §2 checklist: no
NCCL/MPI/network code anywhere); multi-host shuffle join is the new
capability mandated by BASELINE.json's north star and SURVEY.md §7 build
order step 6. The SPMD programs in ``dist_join.py`` / ``dist_executor.py``
are already multi-host-shaped — a 1-D mesh axis spanning **all** global
devices, collectives inside ``shard_map`` — so the only thing that
differs across process counts is how host data enters and leaves the
mesh:

- single process: ``jax.device_put(array, sharding)`` /
  ``np.asarray(global_array)`` both work directly;
- multi process: a process can only touch its *addressable* shards, so
  uploads go through ``jax.make_array_from_callback`` (each process
  materializes only the shard slices it owns) and downloads go through
  an XLA all-gather to a fully-replicated array (``jax.jit`` with
  replicated ``out_shardings``), which every process can then read
  locally.

This module provides those two primitives (:func:`put_sharded`,
:func:`fetch`) plus :func:`init` for cluster bring-up. All call sites in
the distributed layer route through them, so the same engine code runs
on one process with N devices (tests: virtual CPU mesh) and on N
processes each owning a slice of the mesh (tests:
``tests/test_multihost.py`` spawns a real 2-process gloo cluster; on a
GPU host the identical code path runs one process per card over NCCL).

Contract for callers: every process must construct the same ``Plan``
with the same base tables (deterministic loaders — the same contract a
multi-controller JAX program has for its input pipeline). Scans shard
rows across the global mesh, so each process only *uploads* its own
row range even though it *holds* the full table.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax

from .mesh import replicated

_FETCH_CACHE = {}


def init(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
) -> None:
    """Bring up the JAX multi-process cluster (idempotent per process).

    On CPU backends this selects the gloo collectives implementation
    (cross-process all_to_all/psum over TCP); GPU backends use NCCL and
    ignore the setting. ``local_device_count`` pins this process to that
    many local devices (one card per process on a GPU host).
    """
    from jax._src import distributed as _dist

    if _dist.global_state.client is not None:  # already initialized
        return  # (cannot use jax.process_count(): it would init the backend)
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # older/newer jax without the option: backend default
        pass
    kwargs = {}
    if local_device_count is not None:
        kwargs["local_device_ids"] = list(range(local_device_count))
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def active() -> bool:
    """True when more than one process shares the mesh."""
    return jax.process_count() > 1


def put_sharded(array: np.ndarray, sharding):
    """Host array -> global device array with ``sharding``.

    Single process: plain ``device_put``. Multi process: every process
    holds the full host array (replicated input contract above) and
    materializes only its addressable shard slices.
    """
    if not active():
        return jax.device_put(array, sharding)
    return jax.make_array_from_callback(
        array.shape, sharding, lambda idx: array[idx]
    )


def fetch(global_array, mesh) -> np.ndarray:
    """Global (possibly sharded) device array -> full host ndarray,
    valid on every process.

    Single process: ``np.asarray``. Multi process: an XLA all-gather
    into a fully-replicated layout first — after that each process's
    local shard *is* the full value.
    """
    if not active():
        return np.asarray(global_array)
    return np.asarray(fetch_device(global_array, mesh).addressable_data(0))


def fetch_many(arrays, mesh):
    """Fetch a pytree of global arrays in ONE batched transfer.

    ``fetch`` blocks per array (one round trip each); this starts every
    device->host copy together via
    ``jax.device_get`` on the whole tree."""
    if not active():
        return jax.device_get(arrays)
    return jax.device_get(jax.tree.map(
        lambda a: fetch_device(a, mesh).addressable_data(0), arrays))


def fetch_device(global_array, mesh):
    """Like :func:`fetch` but stays on device (replicated layout)."""
    key = id(mesh)
    fn = _FETCH_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda x: x, out_shardings=replicated(mesh))
        _FETCH_CACHE[key] = fn
    return fn(global_array)
