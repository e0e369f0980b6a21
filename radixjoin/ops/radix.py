"""Multi-pass radix partitioning — the HBM-scale join path.

The reference does ONE radix pass sized so each build bucket fits L2
(reference src/execute.cpp:86-92: bucket count = next-pow2 of
``bytes/L2_size``, clamped to [1,128]). Here the tiers are host RAM
and device memory (see :mod:`radixjoin.hardware`):

* **In-HBM repartition** (:func:`partition_device`): bucket ids from the
  murmur finalizer's top bits, then one stable ``lax.sort`` by bucket
  carrying the row id — on a vector machine the sort *is* the scatter
  (histogram + prefix-sum + scatter collapse into it). Used by the
  distributed shuffle and by partition-wise joins.

* **Host-staged partitioning** (:func:`partition_host`): for tables larger
  than device HBM, pass 1 runs on the host (NumPy bincount + argsort-free
  stable counting scatter), producing partition slices whose *pairs* fit
  the device budget; pass 2 streams each partition pair through the
  single-device join. JAX's async dispatch overlaps the H2D upload of
  partition p+1 with the device compute of partition p (double buffering
  falls out of the runtime, not hand-rolled).

:func:`partitioned_join` is exact for any inputs and bounds peak device
memory to O(N / num_partitions); it is the engine's fallback when a join's
working set would not fit HBM, and the building block for the N-host
shuffle join (parallel/dist_join.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .. import hardware
from . import join as join_ops
from .hashing import murmur64, murmur64_np


def choose_num_partitions(
    build_rows: int,
    probe_rows: int,
    bytes_per_row: int = 16,
    budget_bytes: Optional[int] = None,
    max_partitions: int = 128,
) -> int:
    """Partition count so one build+probe partition pair fits the budget.

    Mirrors the reference's bucket sizing (src/execute.cpp:86-92) with the
    budget tier swapped: L2 -> a fraction of device memory (sort scratch
    needs ~4x the partition size; keep pairs under ~1/8 of it by default).
    """
    if budget_bytes is None:
        budget_bytes = hardware.device_memory_bytes() // 8
    budget_bytes = max(1, budget_bytes)
    total = (build_rows + probe_rows) * bytes_per_row
    p = 1 << max(0, math.ceil(math.log2(max(1, total / budget_bytes))))
    return int(min(max(p, 1), max_partitions))


def bucket_of(keys: jnp.ndarray, num_partitions: int) -> jnp.ndarray:
    """Partition id from the hash's TOP bits.

    The distributed shuffle routes on the hash's *low* bits
    (parallel/shuffle.py); using the top bits here keeps intra-device
    partitioning independent of the cross-device routing, so a multi-pass
    pipeline (shuffle, then local radix) never degenerates to one bucket.
    """
    h = murmur64(keys)
    return (h >> jnp.uint64(64 - int(math.log2(num_partitions)))).astype(
        jnp.int32
    ) if num_partitions > 1 else jnp.zeros(keys.shape, jnp.int32)


def bucket_of_np(keys: np.ndarray, num_partitions: int) -> np.ndarray:
    if num_partitions <= 1:
        return np.zeros(keys.shape, np.int32)
    h = murmur64_np(keys)
    return (h >> np.uint64(64 - int(math.log2(num_partitions)))).astype(np.int32)


# ---------------------------------------------------------------------------
# Device-side repartition (one pass)
# ---------------------------------------------------------------------------


def partition_device(
    keys: jnp.ndarray,
    valid: jnp.ndarray,
    num_partitions: int,
):
    """Reorder rows bucket-contiguously on device.

    Returns ``(perm, bucket_sorted)`` where ``perm`` maps sorted slot ->
    original row. Invalid rows keep their bucket (they are dropped later by
    the join's validity masks, reference src/execute.cpp:125,:177 drops
    them at histogram time instead — same semantics, fewer branches).
    Boundaries are ``searchsorted(bucket_sorted, arange(P))``.
    """
    n = keys.shape[0]
    bucket = bucket_of(keys, num_partitions)
    iota = jnp.arange(n, dtype=jnp.int32)
    bucket_sorted, perm = jax.lax.sort((bucket, iota), num_keys=1)
    return perm, bucket_sorted


# ---------------------------------------------------------------------------
# Host-side partitioning (pass 1 of the out-of-HBM path)
# ---------------------------------------------------------------------------


def partition_host(
    keys: np.ndarray,
    valid: np.ndarray,
    payloads: Dict[str, np.ndarray],
    num_partitions: int,
):
    """Stable counting scatter on the host: O(n), no sort.

    Returns ``(parts_keys, parts_valid, parts_payloads, row_ids)`` — lists
    indexed by partition; ``row_ids[p]`` maps partition rows back to the
    original row numbers (for callers that materialize more columns
    lazily).
    """
    bucket = bucket_of_np(keys, num_partitions)
    counts = np.bincount(bucket, minlength=num_partitions)
    order = np.argsort(bucket, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(counts)])
    parts_keys, parts_valid, parts_pay, row_ids = [], [], [], []
    for p in range(num_partitions):
        sel = order[bounds[p] : bounds[p + 1]]
        parts_keys.append(keys[sel])
        parts_valid.append(valid[sel])
        parts_pay.append({k: v[sel] for k, v in payloads.items()})
        row_ids.append(sel)
    return parts_keys, parts_valid, parts_pay, row_ids


# ---------------------------------------------------------------------------
# Partition-wise exact join (pass 2)
# ---------------------------------------------------------------------------


def partitioned_join_indices(
    build_keys: np.ndarray,
    build_valid: np.ndarray,
    probe_keys: np.ndarray,
    probe_valid: np.ndarray,
    num_partitions: Optional[int] = None,
    budget_bytes: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact inner equi-join streamed partition pair by partition pair.

    Host key arrays in; global ``(build_rows, probe_rows)`` index pair out
    (int64) — late materialization is the caller's ``take`` per column.
    Each pair is padded to pow2 buckets so the per-pair jitted programs are
    shared across partitions and queries; JAX async dispatch overlaps the
    upload of pair p+1 with the device compute of pair p. Because rows
    with equal keys land in the same partition on both sides, concatenating
    the per-pair outputs is the exact global join.
    """
    kb = np.asarray(build_keys)
    kp = np.asarray(probe_keys)
    if num_partitions is None:
        num_partitions = choose_num_partitions(
            len(kb), len(kp), budget_bytes=budget_bytes
        )
    bparts = partition_host(kb, np.asarray(build_valid), {}, num_partitions)
    pparts = partition_host(kp, np.asarray(probe_valid), {}, num_partitions)

    out_b: List[np.ndarray] = []
    out_p: List[np.ndarray] = []
    for p in range(num_partitions):
        bk, bv, _, b_rows = (x[p] for x in bparts)
        pk, pv, _, p_rows = (x[p] for x in pparts)
        if len(bk) == 0 or len(pk) == 0:
            continue
        bpad = join_ops.bucket_size(len(bk))
        ppad = join_ops.bucket_size(len(pk))
        bk_d = join_ops.pad_1d(jnp.asarray(bk), bpad)
        bv_d = join_ops.pad_1d(jnp.asarray(bv), bpad)
        pk_d = join_ops.pad_1d(jnp.asarray(pk), ppad)
        pv_d = join_ops.pad_1d(jnp.asarray(pv), ppad)
        bidx, pidx, live, total = join_ops.join_count_and_index(
            bk_d, bv_d, pk_d, pv_d
        )
        if total == 0:
            continue
        live_np = np.asarray(live)
        out_b.append(b_rows[np.asarray(bidx)[live_np][:total]])
        out_p.append(p_rows[np.asarray(pidx)[live_np][:total]])

    if not out_b:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return (
        np.concatenate(out_b).astype(np.int64),
        np.concatenate(out_p).astype(np.int64),
    )


def partitioned_join(
    build_keys: np.ndarray,
    build_valid: np.ndarray,
    build_payloads: Dict[str, np.ndarray],
    probe_keys: np.ndarray,
    probe_valid: np.ndarray,
    probe_payloads: Dict[str, np.ndarray],
    num_partitions: Optional[int] = None,
    budget_bytes: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Payload-dict convenience wrapper over
    :func:`partitioned_join_indices` (``b.``/``p.``-prefixed columns out).
    """
    bidx, pidx = partitioned_join_indices(
        build_keys, build_valid, probe_keys, probe_valid,
        num_partitions, budget_bytes,
    )
    out: Dict[str, np.ndarray] = {}
    for name, col in build_payloads.items():
        out[f"b.{name}"] = np.asarray(col)[bidx]
    for name, col in probe_payloads.items():
        out[f"p.{name}"] = np.asarray(col)[pidx]
    return out
