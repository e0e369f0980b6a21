"""Distributed hash-partitioned shuffle join over a device mesh.

The multi-device generalization of the single-chip two-phase join
(ops/join.py), SPMD via ``shard_map``:

1. both sides live sharded along axis 0 over the 1-D mesh;
2. **skew absorption**: keys detected as heavy hitters bypass the shuffle —
   their build rows are replicated to every device (all_gather of a
   capacity-bounded hot buffer) and their probe rows join locally on their
   home device (broadcast-hot / partition-cold);
3. **radix shuffle**: remaining rows exchange via the capacity-factor
   all-to-all (shuffle.py) so each key lands on ``hash(key) mod ndev``;
4. **local join**: every device runs the same sort + searchsorted
   count/materialize kernels on its received partition;
5. count-then-materialize across the mesh: phase A returns per-device match
   totals (one host sync), the host picks one static output bucket, phase B
   recomputes the shuffle and materializes each device's output shard.

Capacity overflows (possible under adversarial skew) are counted, psum'd,
and surfaced to the driver, which doubles the capacity factor and retries —
results are always exact, never truncated silently.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import join as join_ops
from .mesh import SHARD_AXIS, make_mesh
from . import multihost
from . import shuffle as shuffle_ops


@dataclasses.dataclass
class DistJoinConfig:
    capacity_factor: float = 2.0
    hot_capacity_factor: float = 2.0
    max_hot_keys: int = 16
    hot_threshold: float = 0.25  # fraction of per-device probe capacity
    sample_size: int = 65536
    # Build-side Bloom pre-filter: probe rows whose key hits no set bit
    # cannot match anywhere and stay home (never shuffled) — a semi-join
    # reduction of all_to_all volume. ~8 bits/build-key (≈12% false
    # positives, which just shuffle harmlessly); capped so the psum-OR of
    # the bitmap stays cheap. 0 disables.
    bloom_max_bits: int = 1 << 18
    # >1: split the key space into this many sub-partitions by an
    # independent digit of the routing hash; each sub-partition exchanges
    # and joins separately within the same program, and the unrolled
    # chunk bodies have no data dependence on each other, so XLA's
    # latency-hiding scheduler overlaps chunk c+1's all_to_all with chunk
    # c's local sort/join (the double-buffered-partition overlap of
    # SURVEY.md §7.4). 1 = monolithic exchange (default: no overlap gain
    # has been measured on devices; results are exact either way).
    exchange_chunks: int = 1
    # Cardinality feedback (dist_executor): repeat executions of the same
    # plan shape replay every join sync-free from the learned capacities,
    # hot keys and output buckets, deferring ALL validation to one
    # batched check at the plan root (any mismatch reruns the plan cold —
    # results are exact either way). The distributed analogue of the
    # single-chip RJT_CARD_FEEDBACK.
    feedback: bool = True


def _pad_to_shards(arr: np.ndarray, ndev: int, fill=0):
    n = arr.shape[0]
    per = -(-max(n, 1) // ndev)
    padded = np.full((per * ndev,), fill, dtype=arr.dtype)
    padded[:n] = arr
    return padded


def _is_hot(keys: jnp.ndarray, hot_keys: jnp.ndarray, hot_valid: jnp.ndarray):
    if hot_keys.shape[0] == 0:
        return jnp.zeros(keys.shape, dtype=bool)
    eq = keys[:, None] == hot_keys[None, :].astype(keys.dtype)
    return jnp.any(eq & hot_valid[None, :], axis=1)


def _gather_hot(keys, valid, payloads, hot_mask, hot_cap: int):
    """Compact this device's hot rows into (hot_cap,) and all_gather them."""
    n = keys.shape[0]
    live = valid & hot_mask
    iota = jnp.arange(n, dtype=jnp.int32)
    order = jnp.where(live, iota, n)
    _, perm = jax.lax.sort((order, iota), num_keys=1)
    rank = jnp.arange(n, dtype=jnp.int32)
    in_cap = (rank < hot_cap) & live[perm]
    idx = jnp.where(in_cap, rank, hot_cap)

    def compact(values):
        buf = jnp.zeros((hot_cap + 1,), dtype=values.dtype)
        buf = buf.at[idx].set(values[perm], mode="drop")
        return buf[:hot_cap]

    ck = compact(keys)
    cv = jnp.zeros((hot_cap + 1,), dtype=jnp.bool_).at[idx].set(in_cap, mode="drop")[:hot_cap]
    cp = {k: compact(v) for k, v in payloads.items()}
    overflow = jnp.maximum(jnp.sum(live) - hot_cap, 0)

    gk = jax.lax.all_gather(ck, SHARD_AXIS, tiled=True)
    gv = jax.lax.all_gather(cv, SHARD_AXIS, tiled=True)
    gp = {k: jax.lax.all_gather(v, SHARD_AXIS, tiled=True) for k, v in cp.items()}
    return gk, gv, gp, overflow


def _bloom_member(kb, vb, kp, bits: int):
    """Global build-key membership test for the probe shard.

    Each device sets the bit of every valid local build key in a
    ``bits``-wide bitmap (murmur64 radix, the same hash both sides use
    for routing, so there are NO false negatives); a psum ORs the
    bitmaps across the mesh; the probe shard tests its keys against the
    replicated result. False positives (~12% at 8 bits/key) just shuffle
    harmlessly."""
    from ..ops.hashing import murmur64

    mask = jnp.uint64(bits - 1)
    bi = (murmur64(kb) & mask).astype(jnp.int32)
    one = jnp.ones(kb.shape, dtype=jnp.int32)
    local = jnp.zeros((bits,), jnp.int32).at[
        jnp.where(vb, bi, bits)
    ].max(one, mode="drop")
    global_bits = jax.lax.psum(local, SHARD_AXIS)
    pi = (murmur64(kp) & mask).astype(jnp.int32)
    return global_bits[pi] > 0


def _chunk_of(keys, ndev: int, chunks: int):
    """Sub-partition id: a hash digit independent of the routing digit
    (``% ndev``), so every key's rows land in exactly one chunk on its
    owner device — per-chunk local joins are complete and disjoint."""
    from ..ops.hashing import murmur64

    h = murmur64(keys)
    return ((h // jnp.uint64(ndev)) % jnp.uint64(chunks)).astype(jnp.int32)


def _assemble(
    kb, vb, bpl, kp, vp, ppl, *, ndev, cap_b, cap_p, hot_cap, hot_keys,
    hot_valid, bloom_bits=0, chunks=1
):
    """Per-device exchange. Returns a list of (build, probe) groups this
    device joins locally, plus the psum'd overflow count.

    ``chunks == 1``: one group of shuffled-cold + broadcast-hot rows.
    ``chunks > 1``: one group per key-space sub-partition (each with its
    own all_to_all — unrolled, dependence-free, so the compiler overlaps
    chunk c+1's exchange with chunk c's join) plus a hot group. The
    groups partition the match set exactly: chunk id is a function of
    the key, and hot keys are excluded from every cold shuffle, so all
    cross-group key equalities are impossible."""
    hot_b = _is_hot(kb, hot_keys, hot_valid)
    hot_p = _is_hot(kp, hot_keys, hot_valid)
    if bloom_bits:
        # semi-join reduction: probe rows that cannot match any build key
        # (globally) die here — they neither shuffle nor join at home
        vp = vp & _bloom_member(kb, vb, kp, bloom_bits)

    groups = []
    if chunks == 1:
        rbk, rbv, rbp, overflow = shuffle_ops.shuffle(
            kb, vb, bpl, ndev, cap_b, keep=~hot_b)
        rpk, rpv, rpp, ovf_p = shuffle_ops.shuffle(
            kp, vp, ppl, ndev, cap_p, keep=~hot_p)
        overflow = overflow + ovf_p
        if hot_keys.shape[0] > 0:
            gbk, gbv, gbp, ovf_h = _gather_hot(kb, vb, bpl, hot_b, hot_cap)
            overflow = overflow + jax.lax.psum(ovf_h, SHARD_AXIS).astype(
                overflow.dtype)
            jk = jnp.concatenate([rbk, gbk])
            jv = jnp.concatenate([rbv, gbv])
            jp = {k: jnp.concatenate([rbp[k], gbp[k]]) for k in rbp}
            # hot probe rows stay home: append the local shard masked to hot
            pk = jnp.concatenate([rpk, kp])
            pv = jnp.concatenate([rpv, vp & hot_p])
            pp = {k: jnp.concatenate([rpp[k], ppl[k]]) for k in rpp}
            groups.append(((jk, jv, jp), (pk, pv, pp)))
        else:
            groups.append(((rbk, rbv, rbp), (rpk, rpv, rpp)))
        return groups, overflow

    # one co-sort per side produces every chunk's send slab; only the
    # all_to_alls are per-chunk (so they stay independent and overlappable)
    ch_b = _chunk_of(kb, ndev, chunks)
    ch_p = _chunk_of(kp, ndev, chunks)
    b_out, ovf_b = shuffle_ops.shuffle_chunked(
        kb, vb, bpl, ndev, chunks, cap_b, ch_b, keep=~hot_b)
    p_out, ovf_p = shuffle_ops.shuffle_chunked(
        kp, vp, ppl, ndev, chunks, cap_p, ch_p, keep=~hot_p)
    overflow = ovf_b + ovf_p
    groups.extend(zip(b_out, p_out))
    if hot_keys.shape[0] > 0:
        gbk, gbv, gbp, ovf_h = _gather_hot(kb, vb, bpl, hot_b, hot_cap)
        overflow = overflow + jax.lax.psum(ovf_h, SHARD_AXIS).astype(
            overflow.dtype)
        groups.append(((gbk, gbv, gbp), (kp, vp & hot_p, ppl)))
    return groups, overflow


def _exchange_phase(kb, vb, bpl, kp, vp, ppl, hot_keys, hot_valid, *, ndev,
                    cap_b, cap_p, hot_cap, bloom_bits, chunks):
    """Phase A: exchange + local co-sort + match count, per group.

    Returns every per-device intermediate the expansion needs — the
    received build keys/payloads, probe payloads, and the sort products
    (ids/run starts/offsets) — as sharded outputs, so phase B never
    repeats the all_to_all or the sort (they are the two dominant costs
    of the distributed join; the naive count-then-materialize pattern
    pays both twice)."""
    groups, overflow = _assemble(
        kb, vb, bpl, kp, vp, ppl,
        ndev=ndev, cap_b=cap_b, cap_p=cap_p, hot_cap=hot_cap,
        hot_keys=hot_keys, hot_valid=hot_valid, bloom_bits=bloom_bits,
        chunks=chunks,
    )
    out_groups = []
    total_sum = None
    for (jk, jv, jp), (pk, pv, pp) in groups:
        ids_s, run_start, _, offsets, total = join_ops.join_merge_impl(
            jk, jv, pk, pv
        )
        out_groups.append(dict(
            jk=jk, jp=jp, pp=pp,
            ids_s=ids_s, run_start=run_start, offsets=offsets,
            total=total[None],
        ))
        total_sum = total if total_sum is None else total_sum + total
    return out_groups, total_sum[None], overflow[None]


def _expand_phase(groups, *, s_pad):
    """Phase B: expansion + late materialization at the host-chosen
    static output bucket, from phase A's carried intermediates. Pure
    local compute — no collectives."""
    if len(groups) == 1:
        # monolithic exchange: select-based fill (cheaper than scatter)
        g = groups[0]
        total = g["total"][0]
        bidx, pidx, live = join_ops.join_expand_merge_impl(
            g["ids_s"], g["run_start"], g["offsets"], total, s_pad,
        )
        out = {}
        out["__build_key"] = jnp.where(live, g["jk"][bidx], 0)
        # preserve payload dtypes: a bare 0 fill would promote bool payloads
        # (e.g. chained validity columns) to ints
        for name, values in g["jp"].items():
            zero = jnp.zeros((), dtype=values.dtype)
            out[f"b.{name}"] = jnp.where(live, values[bidx], zero)
        for name, values in g["pp"].items():
            zero = jnp.zeros((), dtype=values.dtype)
            out[f"p.{name}"] = jnp.where(live, values[pidx], zero)
        return out, live

    # chunked exchange: every group's matches are packed at the front of
    # its expansion (live = j < total), so each group scatters its rows
    # into the shared output at a running base offset
    g0 = groups[0]
    out = {"__build_key": jnp.zeros((s_pad,), dtype=g0["jk"].dtype)}
    for name, values in g0["jp"].items():
        out[f"b.{name}"] = jnp.zeros((s_pad,), dtype=values.dtype)
    for name, values in g0["pp"].items():
        out[f"p.{name}"] = jnp.zeros((s_pad,), dtype=values.dtype)
    base = jnp.zeros((), dtype=jnp.int64)
    iota = jnp.arange(s_pad, dtype=jnp.int64)
    for g in groups:
        total = g["total"][0]
        bidx, pidx, live = join_ops.join_expand_merge_impl(
            g["ids_s"], g["run_start"], g["offsets"], total, s_pad,
        )
        pos = jnp.where(live, base + iota, s_pad)
        out["__build_key"] = out["__build_key"].at[pos].set(
            g["jk"][bidx], mode="drop")
        for name, values in g["jp"].items():
            out[f"b.{name}"] = out[f"b.{name}"].at[pos].set(
                values[bidx], mode="drop")
        for name, values in g["pp"].items():
            out[f"p.{name}"] = out[f"p.{name}"].at[pos].set(
                values[pidx], mode="drop")
        base = base + total.astype(base.dtype)
    live = iota < base
    return out, live


def detect_hot_keys(
    probe_keys: np.ndarray,
    probe_valid: np.ndarray,
    config: DistJoinConfig,
    ndev: int,
    cap_p: int,
):
    """Host-side heavy-hitter detection by sampling the probe side.

    A key whose estimated per-mesh frequency would overwhelm its owner
    device's shuffle capacity is routed through the broadcast path instead.
    """
    valid_keys = probe_keys[probe_valid]
    n = len(valid_keys)
    if n == 0:
        return np.zeros(0, dtype=probe_keys.dtype), np.zeros(0, dtype=bool)
    if n > config.sample_size:
        rng = np.random.default_rng(0)
        sample = valid_keys[rng.integers(0, n, config.sample_size)]
        scale = n / config.sample_size
    else:
        sample, scale = valid_keys, 1.0
    threshold = max(2.0, config.hot_threshold * cap_p / scale)
    uniq, counts = np.unique(sample, return_counts=True)
    top = np.argsort(-counts)[: config.max_hot_keys]
    top = top[counts[top] >= threshold]
    hot_arr = uniq[top].astype(probe_keys.dtype)
    return hot_arr, np.ones(len(hot_arr), dtype=bool)


# compiled phase cache: rebuilding jit(shard_map(...)) per call would
# recompile every invocation; phases are cached by their static config
# (hot keys flow in as traced, replicated arguments)
_PHASE_CACHE: Dict[tuple, object] = {}


def _group_specs(bnames: tuple, pnames: tuple, ngroups: int):
    """PartitionSpec pytree mirroring _exchange_phase's per-group output."""
    one = dict(
        jk=P(SHARD_AXIS),
        jp={k: P(SHARD_AXIS) for k in bnames},
        pp={k: P(SHARD_AXIS) for k in pnames},
        ids_s=P(SHARD_AXIS), run_start=P(SHARD_AXIS),
        offsets=P(SHARD_AXIS), total=P(SHARD_AXIS),
    )
    return [dict(one, jp=dict(one["jp"]), pp=dict(one["pp"]))
            for _ in range(ngroups)]


def _phase_fn(
    phase: str, mesh, ndev, cap_b, cap_p, hot_cap,
    bnames: tuple, pnames: tuple, s_pad: Optional[int] = None,
    bloom_bits: int = 0, chunks: int = 1, ngroups: int = 1,
):
    key = (phase, id(mesh), ndev, cap_b, cap_p, hot_cap, bnames, pnames,
           s_pad, bloom_bits, chunks, ngroups)
    fn = _PHASE_CACHE.get(key)
    if fn is not None:
        return fn
    if phase == "exchange":
        in_specs = (P(SHARD_AXIS),) * 2 + (
            {k: P(SHARD_AXIS) for k in bnames},
            P(SHARD_AXIS), P(SHARD_AXIS),
            {k: P(SHARD_AXIS) for k in pnames},
            P(), P(),  # hot_keys / hot_valid replicated
        )
        body = functools.partial(
            _exchange_phase, ndev=ndev, cap_b=cap_b, cap_p=cap_p,
            hot_cap=hot_cap, bloom_bits=bloom_bits, chunks=chunks,
        )
        out_specs = (
            _group_specs(bnames, pnames, ngroups),
            P(SHARD_AXIS), P(SHARD_AXIS),
        )
    else:
        in_specs = (_group_specs(bnames, pnames, ngroups),)
        body = functools.partial(_expand_phase, s_pad=s_pad)
        out_specs = (
            {name: P(SHARD_AXIS) for name in
             ["__build_key"] + [f"b.{k}" for k in bnames]
             + [f"p.{k}" for k in pnames]},
            P(SHARD_AXIS),
        )
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs))
    _PHASE_CACHE[key] = fn
    return fn


def shard_inputs(
    mesh,
    build_keys, build_valid, build_payloads,
    probe_keys, probe_valid, probe_payloads,
):
    """Host -> mesh-sharded device arrays (pad to a shard multiple)."""
    ndev = mesh.devices.size
    kb = _pad_to_shards(build_keys, ndev)
    vb = _pad_to_shards(build_valid.astype(bool), ndev, fill=False)
    kp = _pad_to_shards(probe_keys, ndev)
    vp = _pad_to_shards(probe_valid.astype(bool), ndev, fill=False)
    bpl = {k: _pad_to_shards(v, ndev) for k, v in build_payloads.items()}
    ppl = {k: _pad_to_shards(v, ndev) for k, v in probe_payloads.items()}
    shard = NamedSharding(mesh, P(SHARD_AXIS))
    put = functools.partial(multihost.put_sharded, sharding=shard)
    return (
        put(kb), put(vb), {k: put(v) for k, v in bpl.items()},
        put(kp), put(vp), {k: put(v) for k, v in ppl.items()},
    )


def distributed_join_deferred(
    kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d,
    mesh,
    hot_keys: np.ndarray,
    hot_valid: np.ndarray,
    config: DistJoinConfig,
    info: dict,
    expand: bool = True,
):
    """Both phases with ZERO host syncs: capacities, hot keys and the
    output bucket come from a previous (cold) run's feedback (``info`` as
    populated by :func:`distributed_join_device`'s ``info_out``).

    Returns ``(columns, live, totals_dev, overflow_dev)`` — the caller
    must validate the device check arrays later (batched, e.g. once at
    the plan root): the result is exact iff every overflow count is zero
    AND the fetched totals equal the learned totals the caller planned
    with; otherwise rerun cold. ``expand=False`` skips the materialize
    phase (caller only needs the checks — e.g. a learned-empty join)."""
    ndev = mesh.devices.size
    bnames, pnames = tuple(bpl_d), tuple(ppl_d)
    hk, hv = np.asarray(hot_keys), np.asarray(hot_valid)
    common = dict(bloom_bits=info["bloom_bits"], chunks=info["chunks"],
                  ngroups=info["ngroups"])
    ex_fn = _phase_fn(
        "exchange", mesh, ndev, info["cap_b"], info["cap_p"],
        info["hot_cap"], bnames, pnames, **common,
    )
    groups_dev, totals, overflow = ex_fn(
        kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d, hk, hv)
    if not expand:
        return None, None, totals, overflow
    mat_fn = _phase_fn(
        "expand", mesh, ndev, info["cap_b"], info["cap_p"],
        info["hot_cap"], bnames, pnames, info["s_pad"], **common,
    )
    columns, live = mat_fn(groups_dev)
    return columns, live, totals, overflow


def distributed_join_device(
    kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d,
    mesh,
    hot_keys: np.ndarray,
    hot_valid: np.ndarray,
    config: Optional[DistJoinConfig] = None,
    info_out: Optional[dict] = None,
):
    """Run the two SPMD phases on already-sharded device arrays.

    ``info_out``, if given, is populated with the resolved static config
    (capacities, bucket, group census) so a caller can replay the join
    sync-free via :func:`distributed_join_deferred`."""
    config = config or DistJoinConfig()
    ndev = mesh.devices.size
    bl = kb_d.shape[0] // ndev
    pl = kp_d.shape[0] // ndev
    bnames = tuple(bpl_d)
    pnames = tuple(ppl_d)
    # numpy (host-replicated) values: under multi-process every process
    # passes the same bytes, matching the replicated P() in_spec
    hk = np.asarray(hot_keys)
    hv = np.asarray(hot_valid)

    # Capacity ladder: each retry doubles every receive buffer — the
    # radix-shuffle capacities AND the hot-broadcast buffer (a skewed
    # *build* side overflows the hot buffer, which probe-side sampling
    # cannot predict) — clamped at the provably-sufficient worst case
    # (one device receives every row / every local row is hot). Only an
    # overflow at worst-case capacity is an error.
    # Bloom sizing: ~8 bits per global build key, pow2 for mask-indexing,
    # capped so the per-phase psum stays small relative to the exchange
    bloom_bits = 0
    if config.bloom_max_bits:
        want = 1 << max(13, (8 * bl * ndev - 1).bit_length())
        bloom_bits = min(int(config.bloom_max_bits), want)
        # _bloom_member mask-indexes with bits-1: a non-pow2 cap would
        # silently collapse the filter to the cap's low set bits
        bloom_bits = 1 << (bloom_bits.bit_length() - 1)

    # chunked exchange: per-chunk receive buffers start at 1/chunks of the
    # monolithic estimate (the ladder still climbs to the same worst case)
    chunks = max(1, int(config.exchange_chunks))

    # group census must match _assemble's static structure: chunks==1
    # folds the hot rows into the single group; chunks>1 gives them
    # their own group
    has_hot = len(hk) > 0
    ngroups = (chunks + (1 if has_hot else 0)) if chunks > 1 else 1

    m = 1.0
    while True:
        cap_b = min(max(16, bl * ndev),
                    max(16, int(m * config.capacity_factor * bl
                                / (ndev * chunks)) + 1))
        cap_p = min(max(16, pl * ndev),
                    max(16, int(m * config.capacity_factor * pl
                                / (ndev * chunks)) + 1))
        hot_cap = min(
            max(16, bl),
            max(16, int(m * config.hot_capacity_factor * bl / ndev) + 1),
        )
        ex_fn = _phase_fn(
            "exchange", mesh, ndev, cap_b, cap_p, hot_cap, bnames, pnames,
            bloom_bits=bloom_bits, chunks=chunks, ngroups=ngroups,
        )
        groups_dev, totals, overflow = ex_fn(
            kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d, hk, hv)
        # one batched round trip for both scalars-per-device
        totals_h, overflow_h = multihost.fetch_many((totals, overflow), mesh)
        if int(np.max(overflow_h)) == 0:
            break
        at_worst_case = (
            cap_b >= max(16, bl * ndev)
            and cap_p >= max(16, pl * ndev)
            and hot_cap >= max(16, bl)
        )
        if at_worst_case:
            raise RuntimeError(
                "shuffle overflow at worst-case capacity (engine bug)"
            )
        m *= 2.0

    # phase B expands from phase A's carried (sharded) intermediates —
    # the exchange and the sort are never recomputed, and the totals the
    # ladder already fetched size the bucket (no further sync)
    s_pad = join_ops.bucket_size(int(np.max(totals_h)))
    ex_fn = _phase_fn(
        "expand", mesh, ndev, cap_b, cap_p, hot_cap, bnames, pnames,
        s_pad, bloom_bits=bloom_bits, chunks=chunks, ngroups=ngroups,
    )
    columns, live = ex_fn(groups_dev)
    if info_out is not None:
        info_out.update(
            cap_b=cap_b, cap_p=cap_p, hot_cap=hot_cap, s_pad=s_pad,
            bloom_bits=bloom_bits, chunks=chunks, ngroups=ngroups,
        )
    return columns, live, totals_h


def distributed_join(
    build_keys: np.ndarray,
    build_valid: np.ndarray,
    build_payloads: Dict[str, np.ndarray],
    probe_keys: np.ndarray,
    probe_valid: np.ndarray,
    probe_payloads: Dict[str, np.ndarray],
    mesh=None,
    config: Optional[DistJoinConfig] = None,
):
    """Exact distributed inner join. Returns (columns, live, totals) where
    ``columns`` maps '__build_key' / 'b.*' / 'p.*' to mesh-sharded arrays of
    shape (ndev*s_pad,), ``live`` flags real output rows, and ``totals`` is
    the per-device match count as a host ndarray (already fetched — the
    capacity ladder needed it, so callers must not fetch again)."""
    config = config or DistJoinConfig()
    mesh = mesh or make_mesh()
    ndev = mesh.devices.size

    kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d = shard_inputs(
        mesh, build_keys, build_valid, build_payloads,
        probe_keys, probe_valid, probe_payloads,
    )
    pl = kp_d.shape[0] // ndev
    # the hot threshold must reflect the buffer a key actually lands in:
    # with a chunked exchange that is the 1/chunks-sized per-chunk slab
    chunks = max(1, int(config.exchange_chunks))
    cap_p = max(16, int(config.capacity_factor * pl / (ndev * chunks)) + 1)
    hot_keys, hot_valid = detect_hot_keys(
        np.asarray(_pad_to_shards(probe_keys, ndev)),
        np.asarray(_pad_to_shards(probe_valid.astype(bool), ndev, fill=False)),
        config, ndev, cap_p,
    )
    return distributed_join_device(
        kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d, mesh, hot_keys, hot_valid, config
    )


def collect_to_host(columns, live, mesh=None) -> Dict[str, np.ndarray]:
    """Concatenate the sharded output to dense host arrays (drops padding).

    Pass ``mesh`` under multi-process execution so the gather rides an
    XLA all-gather (every process receives the full result)."""
    if mesh is not None:
        live_np = multihost.fetch(live, mesh)
        return {k: multihost.fetch(v, mesh)[live_np] for k, v in columns.items()}
    live_np = np.asarray(live)
    return {k: np.asarray(v)[live_np] for k, v in columns.items()}
