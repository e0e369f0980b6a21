"""Radix shuffle: hash-partitioned all-to-all exchange (per-device code).

Every function in this module runs *inside* ``shard_map`` — it sees one
device's shard and communicates via named-axis collectives.

The exchange uses the capacity-factor pattern (the idiomatic static-shape
form of data-dependent routing, as in MoE dispatch): each device bucketizes its
rows by ``murmur64(key) mod ndev``, scatters them into a static
``(ndev, capacity)`` send buffer, and a single ``lax.all_to_all`` swaps
bucket ``d`` to device ``d``. Rows beyond ``capacity`` in any bucket are
dropped *and counted* — the driver checks the psum'd overflow count and
retries with a larger capacity (a shape change, so a recompile; rare with
capacity factor 2 unless keys are heavily skewed, which the skew path in
dist_join.py absorbs first).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..ops.hashing import murmur64
from .mesh import SHARD_AXIS


def dest_of(keys: jnp.ndarray, ndev: int) -> jnp.ndarray:
    """Destination device of each key (high-entropy radix of the hash)."""
    return (murmur64(keys) % jnp.uint64(ndev)).astype(jnp.int32)


def bucketize(
    keys: jnp.ndarray,
    valid: jnp.ndarray,
    payloads: Dict[str, jnp.ndarray],
    ndev: int,
    capacity: int,
    keep: jnp.ndarray = None,
    chunk_ids: jnp.ndarray = None,
    chunks: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray, Dict[str, jnp.ndarray], jnp.ndarray]:
    """Scatter local rows into a (ndev, capacity) send layout — or, with
    ``chunks > 1``, a (chunks, ndev, capacity) layout in ONE co-sort keyed
    by (chunk, destination): the chunked exchange needs independent
    per-chunk send buffers, not ``chunks`` separate full-shard sorts.

    ``keep`` optionally masks rows out of the exchange entirely (the skew
    path routes hot-key rows around the shuffle). Invalid rows are dropped
    (they can never join; shipping them would waste capacity).

    Returns (send_keys, send_valid, send_payloads, overflow_count).
    """
    n = keys.shape[0]
    nb = ndev * chunks  # real buckets, chunk-major
    live = valid if keep is None else (valid & keep)
    dest = dest_of(keys, ndev)
    if chunks > 1:
        dest = chunk_ids * ndev + dest
    dest = jnp.where(live, dest, nb)  # dead rows sort to a virtual bucket

    # stable bucket ordering: sort rows by (chunk, destination)
    iota = jnp.arange(n, dtype=jnp.int32)
    dest_sorted, perm = jax.lax.sort((dest, iota), num_keys=1)

    counts = jnp.bincount(dest, length=nb + 1)[:nb]
    offsets = jnp.cumsum(counts) - counts  # exclusive, per real bucket
    rank = jnp.arange(n, dtype=jnp.int32) - jnp.take(
        jnp.append(offsets, n).astype(jnp.int32), dest_sorted, fill_value=0
    )

    in_cap = (rank < capacity) & (dest_sorted < nb)
    flat_idx = jnp.where(in_cap, dest_sorted * capacity + rank, nb * capacity)

    shape = (chunks, ndev, capacity) if chunks > 1 else (ndev, capacity)

    def scatter(values, fill):
        buf = jnp.full((nb * capacity + 1,), fill, dtype=values.dtype)
        buf = buf.at[flat_idx].set(values[perm], mode="drop")
        return buf[:-1].reshape(shape)

    send_keys = scatter(keys, jnp.zeros((), keys.dtype))
    send_valid = scatter(live, jnp.zeros((), jnp.bool_))
    send_payloads = {k: scatter(v, jnp.zeros((), v.dtype)) for k, v in payloads.items()}
    overflow = jnp.sum(jnp.maximum(counts - capacity, 0))
    return send_keys, send_valid, send_payloads, overflow


def exchange(buf: jnp.ndarray) -> jnp.ndarray:
    """All-to-all: row d of the local (ndev, capacity, ...) buffer goes to
    device d; row s of the result came from device s."""
    return jax.lax.all_to_all(buf, SHARD_AXIS, split_axis=0, concat_axis=0, tiled=False)


def shuffle(
    keys: jnp.ndarray,
    valid: jnp.ndarray,
    payloads: Dict[str, jnp.ndarray],
    ndev: int,
    capacity: int,
    keep: jnp.ndarray = None,
):
    """Full hash shuffle of one side. Returns flattened received rows
    (ndev*capacity,) plus the global overflow count (psum'd)."""
    send_keys, send_valid, send_payloads, overflow = bucketize(
        keys, valid, payloads, ndev, capacity, keep
    )
    recv_keys = exchange(send_keys).reshape(-1)
    recv_valid = exchange(send_valid).reshape(-1)
    recv_payloads = {k: exchange(v).reshape(-1) for k, v in send_payloads.items()}
    total_overflow = jax.lax.psum(overflow, SHARD_AXIS)
    return recv_keys, recv_valid, recv_payloads, total_overflow


def shuffle_chunked(
    keys: jnp.ndarray,
    valid: jnp.ndarray,
    payloads: Dict[str, jnp.ndarray],
    ndev: int,
    chunks: int,
    capacity: int,
    chunk_ids: jnp.ndarray,
    keep: jnp.ndarray = None,
):
    """Chunked hash shuffle: ONE co-sort bucketizes every row by
    (chunk, destination), then each chunk's (ndev, capacity) slab rides
    its own all_to_all — the per-chunk exchanges stay independent (the
    overlap the chunked join relies on) without re-sorting the shard
    per chunk. Returns ([(keys, valid, payloads)] per chunk, overflow)."""
    send_keys, send_valid, send_payloads, overflow = bucketize(
        keys, valid, payloads, ndev, capacity, keep,
        chunk_ids=chunk_ids, chunks=chunks,
    )
    out = []
    for c in range(chunks):
        rk = exchange(send_keys[c]).reshape(-1)
        rv = exchange(send_valid[c]).reshape(-1)
        rp = {k: exchange(v[c]).reshape(-1) for k, v in send_payloads.items()}
        out.append((rk, rv, rp))
    return out, jax.lax.psum(overflow, SHARD_AXIS)


def global_histogram(keys: jnp.ndarray, valid: jnp.ndarray, num_buckets: int):
    """psum'd histogram over hash buckets — the distributed analogue of the
    reference's serial radix histogram (src/execute.cpp:124-132)."""
    h = (murmur64(keys) % jnp.uint64(num_buckets)).astype(jnp.int32)
    h = jnp.where(valid, h, num_buckets)
    local = jnp.bincount(h, length=num_buckets + 1)[:num_buckets]
    return jax.lax.psum(local, SHARD_AXIS)
