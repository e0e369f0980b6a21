"""Shape-shared plan executor.

The fused engine (plan/fused.py) compiles one XLA program per query; a
suite of N queries lowers to N+ distinct programs. This executor instead
runs the plan as a chain of SMALL jitted kernels whose shapes are pow2-padded
(ops/join.py bucket_size), so the same compiled executable serves every
join of the same (build_pad, probe_pad, out_pad, dtype, payload signature)
across ALL queries — after a handful of queries everything is warm, even
with a cold disk cache.

Latency discipline (every device->host sync stalls the dispatch stream):

* intermediates stay on device; kernels chain without host round trips;
* FK->PK joins (verified-unique build keys, ops/join.py
  ``join_unique_impl``) produce probe-shaped outputs — no output-size
  choice, hence NO sync at all;
* general joins write into a static bucket seeded by the probe pad and
  emit their exact ``total`` as a device scalar; all totals are fetched in
  ONE batched transfer at the root, and only overflowing joins (rare) are
  re-run with exact buckets — node results are memoized so the retry
  recomputes only the overflowed subtree;
* base-table device uploads are memoized on the host column object, so a
  table shared by many queries is transferred once per process.

Reference parity: this is the ``execute_impl`` tree walk
(src/execute.cpp:302-314) with the allocator-bound row loop replaced by
static-shape array programs.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import DataType
from ..ops import join as join_ops
from .ir import JoinNode, Plan, ScanNode

# ---------------------------------------------------------------------------
# Shape-shared jitted kernels (jax.jit caches by input shape/dtype/pytree)
# ---------------------------------------------------------------------------


def _gather_cols(cols, idx, live):
    """Late materialization: gather every (data, valid) pair at ``idx``.
    Returns a tuple of (data, valid & live) in input order."""
    return tuple((d[idx], v[idx] & live) for d, v in cols)


@functools.partial(jax.jit, static_argnames=("out_pad",))
def _join_general(kb, vb, kp, vp, bcols, pcols, out_pad: int):
    """Count + expand + gather for a duplicate-capable build side
    (three-sort formulation: build sort + two sort-based searchsorteds).

    ``bcols``/``pcols``: tuples of (data, valid) payload arrays. Returns
    (out_b, out_p, live, total) with outputs in the ``out_pad`` bucket.
    """
    perm, lo, _counts, offsets, total = join_ops.join_count_impl(kb, vb, kp, vp)
    bidx, pidx, live = join_ops.join_expand_impl(perm, lo, offsets, total, out_pad)
    out_b = _gather_cols(bcols, bidx, live)
    out_p = _gather_cols(pcols, pidx, live)
    return out_b, out_p, live, total


@functools.partial(jax.jit, static_argnames=("out_pad",))
def _join_general_merge(kb, vb, kp, vp, bcols, pcols, out_pad: int):
    """Single-sort merge-join formulation (join_merge_full_impl): ~45%
    less sort work than the three-sort path, payload planes sort-carried
    (no serial gathers); output rows ordered by sorted probe position (a
    legal multiset ordering)."""
    out_b, out_p, live, total = join_ops.join_merge_full_impl(
        kb, vb, kp, vp, out_pad, bcols, pcols
    )
    return tuple(out_b), tuple(out_p), live, total


def _general_impl():
    import os

    return (
        _join_general_merge
        if os.environ.get("RJT_GENERAL_JOIN", "merge") == "merge"
        else _join_general
    )


@jax.jit
def _join_unique(kb, vb, kp, vp, bcols):
    """FK->PK fast path: probe-shaped output, no bucket choice, no sync.

    Probe payloads are NOT passed through the kernel — the caller just
    ANDs ``found`` into their validity (see ``_mask_cols``).
    """
    bidx, found, total = join_ops.join_unique_impl(kb, vb, kp, vp)
    out_b = _gather_cols(bcols, bidx, found)
    return out_b, found, total


@functools.lru_cache(maxsize=None)
def _dev_scalar_i64(v: int):
    """Device-resident i64 scalar, cached by value. A fresh numpy scalar
    argument would cost one synchronous H2D transfer on *every* jitted
    call; distinct join-key window bases across a workload number only in
    the dozens."""
    return jax.device_put(jnp.int64(v))


@functools.partial(jax.jit, static_argnames=("r_pad",))
def _join_unique_scatter(kb, vb, kp, vp, base, bcols, r_pad: int):
    """Sort-free FK->PK fast path: dense key-window slot table
    (ops/join.py join_unique_scatter_impl) — memset + scatter + gather
    instead of sorts. Probe-shaped like _join_unique."""
    bidx, found, total = join_ops.join_unique_scatter_impl(
        kb, vb, kp, vp, base, r_pad
    )
    out_b = _gather_cols(bcols, bidx, found)
    return out_b, found, total


def _unique_scatter_window(plan: Plan, j, battr: int, bpad: int, ppad: int):
    """Static key window (base, r_pad) for the scatter unique join, from
    host-side stats of the build scan's key column — _detect_unique_joins
    guarantees the build child is a scan, so the column is a base host
    column and the window costs one memoized numpy min/max.

    Returns None when the scatter path shouldn't be used (disabled, or the
    key window is too sparse relative to the join size for the dense slot
    table to beat the sort path).

    Default **auto**; RJT_UNIQUE_JOIN=sort restores the sort path."""
    import os

    mode = os.environ.get("RJT_UNIQUE_JOIN", "auto")
    if mode == "sort":
        return None
    build_child = plan.nodes[j.left if j.build_left else j.right]
    col_idx, _dt = build_child.output_attrs[battr]
    hcol = plan.inputs[build_child.data.base_table_id].to_host().columns[col_idx]
    rng = hcol.valid_range()
    if rng is None:
        return 0, join_ops.MIN_BUCKET  # no valid build rows -> no matches
    base, hi = rng
    r_pad = join_ops.bucket_size(hi - base + 1)
    if r_pad > (1 << 26):
        return None  # cap the slot table at 256 MiB of HBM
    if mode != "scatter" and r_pad > max(1 << 20, 32 * (bpad + ppad)):
        return None  # window too sparse vs the sort cost
    return base, r_pad


@functools.partial(jax.jit, static_argnames=("s_pad",))
def _join_general_csr(
    counts_w, starts_w, grouped, kp, vp, base, bcols, pcols, s_pad: int
):
    """Sort-free general join against a host-pregrouped (CSR) build scan
    (ops/join.py join_csr_impl): window gathers + one cumsum + the
    scatter-max expansion — no ``lax.sort``. Same contract as
    _join_general_merge."""
    bidx, pidx, live, total = join_ops.join_csr_impl(
        counts_w, starts_w, grouped, kp, vp, base, s_pad
    )
    out_b = _gather_cols(bcols, bidx, live)
    out_p = _gather_cols(pcols, pidx, live)
    return out_b, out_p, live, total


def _csr_device(hcol):
    """Upload memo for a column's CSR index: one transfer per process
    (charged to the device ledger; evicted under memory pressure). Same
    pin-first concurrency protocol as :func:`_device_column_cached`."""
    from .. import engine as _eng

    dev = getattr(hcol, "_csr_dev_memo", None)
    if dev == (None,):
        return None
    if (dev is not None and _eng.device_ledger().touch(hcol)
            and not dev[1].is_deleted()):
        return dev
    with _owner_lock(hcol):
        _eng.device_ledger().charge(hcol, 0, _eng._release_column_caches)
        dev = getattr(hcol, "_csr_dev_memo", None)
        if dev == (None,):
            return None
        if dev is not None and not dev[1].is_deleted():
            return dev
        object.__setattr__(hcol, "_csr_dev_memo", None)
        idx = hcol.csr_index()
        if idx is None:
            dev = (None,)
        else:
            base, counts_w, starts_w, grouped = idx
            dev = (
                _dev_scalar_i64(base),
                jax.device_put(counts_w),
                jax.device_put(starts_w),
                jax.device_put(grouped),
            )
            _eng.device_ledger().charge(
                hcol,
                sum(a.size * a.dtype.itemsize for a in dev[1:]),
                _eng._release_column_caches,
            )
        object.__setattr__(hcol, "_csr_dev_memo", dev)
    return None if dev == (None,) else dev


def _child_csr_index(plan: Plan, child_idx: int, attr: int,
                     bpad: int, ppad: int, mode: str):
    """Device CSR index over one child's key column, or None when that
    child is not a base scan / non-int key / too-sparse window."""
    child = plan.nodes[child_idx]
    if not isinstance(child.data, ScanNode):
        return None
    col_idx, dt = child.output_attrs[attr]
    if dt not in (DataType.INT32, DataType.INT64):
        return None
    hcol = plan.inputs[child.data.base_table_id].to_host().columns[col_idx]
    rng = hcol.valid_range()
    if rng is not None and mode != "force":
        r = join_ops.bucket_size(rng[1] - rng[0] + 1)
        if r > max(1 << 20, 32 * (bpad + ppad)):
            return None  # window too sparse vs the sort cost
    dev = _csr_device(hcol)
    return None if dev is None else (dev, hcol)


def _origin_host_column(plan: Plan, node_idx: int, attr: int):
    """Provenance walk: the base HostColumn a node's output attr descends
    from (every join output column is a gather of some scan column), or
    None for non-integer origins. Pure plan analysis — no runtime data."""
    node = plan.nodes[node_idx]
    if isinstance(node.data, ScanNode):
        col_idx, dt = node.output_attrs[attr]
        if dt not in (DataType.INT32, DataType.INT64):
            return None
        return plan.inputs[node.data.base_table_id].to_host().columns[col_idx]
    j = node.data
    left_w = len(plan.nodes[j.left].output_attrs)
    ci, _dt = node.output_attrs[attr]
    if ci < left_w:
        return _origin_host_column(plan, j.left, ci)
    return _origin_host_column(plan, j.right, ci - left_w)


def _dev_csr_window(plan: Plan, j, battr: int, pattr: int,
                    bpad: int, ppad: int):
    """Key window for the device-CSR general join (both children
    intermediate): ``(swapped, base, r_pad)`` or None.

    The window comes from the key column's origin base column
    (:func:`_origin_host_column`): every key value in an intermediate is
    a gathered base value, so valid keys are in-window by construction.
    The smaller-padded side is preferred as the indexed (sorted) side.
    ``RJT_DEV_CSR=off`` disables; ``force`` skips the economy test."""
    import os

    mode = os.environ.get("RJT_DEV_CSR", "auto")
    if mode == "off":
        return None
    bchild = j.left if j.build_left else j.right
    pchild = j.right if j.build_left else j.left
    cands = sorted([
        (bpad, False, bchild, battr),
        (ppad, True, pchild, pattr),
    ])
    for _pad, swapped, child, attr in cands:
        hcol = _origin_host_column(plan, child, attr)
        if hcol is None:
            continue
        rng = hcol.valid_range()
        if rng is None:
            # origin column has no valid values -> all keys NULL ->
            # empty join via window misses (still exact)
            return swapped, 0, join_ops.MIN_BUCKET
        base, hi = rng
        r_pad = join_ops.bucket_size(hi - base + 1)
        if r_pad > (1 << 26):
            continue  # cap window arrays at 256 MiB of HBM
        if mode != "force" and r_pad > max(1 << 20, 32 * (bpad + ppad)):
            continue  # window too sparse vs the merge-sort cost
        return swapped, base, r_pad
    return None


@functools.partial(jax.jit, static_argnames=("r_pad", "s_pad"))
def _join_dev_csr(kb, vb, kp, vp, base, bcols, pcols, r_pad: int, s_pad: int):
    """Device-built CSR general join (ops/join.py join_dev_csr_impl):
    histogram + cumsum over the key window + one indexed-side-only sort.
    Same contract as _join_general_csr."""
    bidx, pidx, live, total = join_ops.join_dev_csr_impl(
        kb, vb, kp, vp, base, r_pad, s_pad
    )
    out_b = _gather_cols(bcols, bidx, live)
    out_p = _gather_cols(pcols, pidx, live)
    return out_b, out_p, live, total


def _general_csr_index(plan: Plan, j, battr: int, pattr: int,
                       bpad: int, ppad: int):
    """CSR index for a general join: ``(index, swapped)`` or None.

    Prefers indexing the build child; when only the *probe* child is a
    base scan the roles swap (``swapped=True``) — an inner join is a
    multiset, so which side is dense-indexed is pure strategy, exactly
    like the reference's free choice of build side (src/execute.cpp
    build_left): in JOB-shaped plans most general joins have a scan on
    the probe side only, so the swap converts the bulk of the sorts.

    Default **auto**; RJT_CSR_JOIN=off restores the merge-sort path."""
    import os

    mode = os.environ.get("RJT_CSR_JOIN", "auto")
    if mode == "off":
        return None
    hit = _child_csr_index(
        plan, j.left if j.build_left else j.right, battr, bpad, ppad, mode
    )
    if hit is not None:
        return hit[0], False, hit[1]
    hit = _child_csr_index(
        plan, j.right if j.build_left else j.left, pattr, ppad, bpad, mode
    )
    if hit is not None:
        return hit[0], True, hit[1]
    return None


# Join-path observability: execution strategy counts per process
# (reference has per-query wall-clock prints only, read_sql.cpp:1243-1246;
# here the interesting axis is which kernel family each join picked).
PATH_STATS: Dict[str, int] = {}


def _count_path(name: str) -> None:
    PATH_STATS[name] = PATH_STATS.get(name, 0) + 1


def path_stats() -> Dict[str, int]:
    """Snapshot of join-path counts: unique_scatter /
    unique_sort / general_csr / general_merge / empty_type_mismatch."""
    return dict(PATH_STATS)


@jax.jit
def _mask_cols(cols, mask):
    return tuple((d, v & mask) for d, v in cols)


# ---------------------------------------------------------------------------
# Single-buffer fetch: every device_get buffer is its own transfer, so all
# host-bound values of a sync are bitcast to uint8 and concatenated into
# ONE device buffer, fetched once, and re-viewed on the host.
# ---------------------------------------------------------------------------


@jax.jit
def _pack_u8(arrays):
    parts = []
    for a in arrays:
        if a.dtype == jnp.bool_:
            a = a.astype(jnp.uint8)
        if a.ndim == 0:
            a = a.reshape(1)
        if a.dtype.itemsize == 1:
            parts.append(a.reshape(-1).astype(jnp.uint8))
        else:
            parts.append(jax.lax.bitcast_convert_type(a, jnp.uint8).reshape(-1))
    return jnp.concatenate(parts) if parts else jnp.zeros(0, jnp.uint8)


def pack_bundle(arrays):
    """Device-side pack of a mixed-dtype array list into one u8 buffer.

    Returns ``(buf_dev, spec)``; ``buf_dev`` is a single device array (so
    the host transfer is one buffer = one round trip) and ``spec``
    is what :func:`unpack_bundle` needs to restore the originals. Returns
    ``(None, spec)`` for an empty list."""
    arrays = list(arrays)
    if not arrays:
        return None, (tuple(), tuple())
    # pack wide dtypes first so every view offset stays aligned
    order = tuple(sorted(
        range(len(arrays)),
        key=lambda i: -np.dtype(
            np.uint8 if arrays[i].dtype == jnp.bool_ else arrays[i].dtype
        ).itemsize,
    ))
    buf = _pack_u8(tuple(arrays[i] for i in order))
    meta = tuple(
        (a.ndim, tuple(a.shape), np.dtype(np.uint8) if a.dtype == jnp.bool_
         else np.dtype(a.dtype), a.dtype == jnp.bool_)
        for a in arrays
    )
    return buf, (order, meta)


def unpack_bundle(buf: np.ndarray, spec):
    """Host-side inverse of :func:`pack_bundle` (buf already fetched)."""
    order, meta = spec
    out = [None] * len(meta)
    off = 0
    for i in order:
        ndim, shape, dt, is_bool = meta[i]
        shape = (1,) if ndim == 0 else shape
        if is_bool:
            n = int(np.prod(shape))
            v = buf[off:off + n].astype(bool).reshape(shape)
        else:
            n = int(np.prod(shape)) * dt.itemsize
            v = buf[off:off + n].view(dt).reshape(shape)
        off += n
        out[i] = v[0] if ndim == 0 else v
    return out


def fetch_bundle(arrays):
    """device_get a list of arrays (mixed dtypes, incl. bool/scalars) in a
    single transfer; returns numpy arrays in order."""
    buf, spec = pack_bundle(arrays)
    if buf is None:
        return []
    return unpack_bundle(np.asarray(buf), spec)


@functools.partial(jax.jit, static_argnames=("n",))
def _slice_cols(arrays, n: int):
    return tuple(a[:n] for a in arrays)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class _NodeResult:
    """Device columns of one executed plan node."""

    __slots__ = ("cols", "total_dev", "pad", "compacted", "dicts", "live")

    def __init__(self, cols, total_dev, pad, compacted, dicts, live=None):
        self.cols = cols  # list[(data, valid)]
        self.total_dev = total_dev  # device scalar or python int once known
        self.pad = pad
        self.compacted = compacted  # rows [0:total) are the live rows
        self.dicts = dicts  # per-col StringDict or None
        #: probe-shaped nodes only: the match mask (a row with a NULL
        #: payload is live but invalid — compaction must use this, not the
        #: per-column validity)
        self.live = live


# Shrink policy: syncing a wave's totals costs one device->host round trip
# but lets every downstream sort run at live-row scale. That trade only
# pays on the heavy tail, so by default a query syncs at most once and
# only for waves holding a >=2^18-padded node. Env overrides:
# RJT_SHRINK_MIN_PAD, RJT_SHRINK_MAX_SYNCS.
_SHRINK_FACTOR = 4


def _shrink_policy():
    import os

    return (
        int(os.environ.get("RJT_SHRINK_MIN_PAD", str(1 << 18))),
        int(os.environ.get("RJT_SHRINK_MAX_SYNCS", "1")),
    )


@functools.partial(jax.jit, static_argnames=("out_pad",))
def _compact_probe_shaped(cols, live, out_pad: int):
    """Compact live rows to the front of an ``out_pad`` bucket (the same
    scatter-max owner recovery as join expansion, counts in {0,1})."""
    n = live.shape[0]
    counts = live.astype(jnp.int64)
    offsets = jnp.cumsum(counts) - counts
    total = jnp.sum(counts)
    starts = jnp.where(live, offsets, out_pad)
    marker = jnp.full(out_pad + 1, -1, dtype=jnp.int32)
    marker = marker.at[starts].max(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    src = jnp.clip(
        jax.lax.cummax(marker[:out_pad]), 0, n - 1
    )
    live_out = jnp.arange(out_pad, dtype=jnp.int64) < total
    return _gather_cols(cols, src, live_out)


def _shrink_node(res: _NodeResult, total: int) -> _NodeResult:
    """Shrink a node to its exact bucket once ``total`` is known: free
    slicing for compacted nodes, a compaction kernel for probe-shaped."""
    new_pad = join_ops.bucket_size(total)
    if res.compacted:
        if new_pad >= res.pad:
            res.total_dev = total
            return res
        arrays = tuple(d for d, _ in res.cols) + tuple(v for _, v in res.cols)
        sliced = _slice_cols(arrays, new_pad)
        k = len(res.cols)
        cols = list(zip(sliced[:k], sliced[k:]))
        return _NodeResult(cols, total, new_pad, True, res.dicts)
    if new_pad * _SHRINK_FACTOR > res.pad:
        res.total_dev = total
        return res
    cols = _compact_probe_shaped(tuple(res.cols), res.live, new_pad)
    return _NodeResult(list(cols), total, new_pad, True, res.dicts)


def _levels(plan: Plan, order):
    level: Dict[int, int] = {}
    for idx in order:
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            level[idx] = 0
        else:
            level[idx] = 1 + max(level[node.data.left], level[node.data.right])
    return level


def run_plan(plan: Plan, unique_joins: frozenset, max_attempts: int = 12):
    """Execute ``plan`` in topological waves.

    After each wave containing a big node, its exact totals are fetched
    (one small sync) and oversized intermediates are shrunk before the
    next wave dispatches — JOB joins are highly selective, so downstream
    sorts then run at live-row scale instead of the base-table pad.
    General-join overflows in a synced wave are re-dispatched immediately
    with exact buckets (their consumers have not run yet); overflows in
    never-synced (small) waves are fixed up by recomputing the affected
    ancestor chain at the end.

    **Cardinality feedback** (``RJT_CARD_FEEDBACK``, default on): a
    successful run records each join's exact bucket on the plan object;
    repeat executions of the same plan (prepared-statement style) seed
    general joins with those exact buckets and compact probe-shaped
    outputs to their known size right after dispatch — all downstream
    work then runs at live-row scale with ZERO mid-flight syncs. Stale
    feedback (the data changed) is caught by the same exact-totals
    overflow check and the affected subtree recomputes, so results stay
    exact. JOB joins are highly selective, which is why this and the
    first-run wave shrink pay (the reference has no analogue: its
    vectors grow dynamically, src/execute.cpp:232-243).

    Returns ``(root_result, totals_by_node, prefetched_root_or_None)``.
    """
    import os

    from .. import engine as eng

    buckets: Dict[int, int] = {}
    order = plan.topo_order()
    join_ids = [i for i in order if isinstance(plan.nodes[i].data, JoinNode)]
    level = _levels(plan, order)
    results: Dict[int, _NodeResult] = {}
    totals_by_node: Dict[int, int] = {}

    feedback_on = os.environ.get("RJT_CARD_FEEDBACK", "on") != "off"
    learned = getattr(plan, "_learned_buckets", None) if feedback_on else None
    if learned:
        for idx, (pad, was_compacted) in learned.items():
            if was_compacted:
                buckets.setdefault(idx, pad)

    for idx in order:
        if isinstance(plan.nodes[idx].data, ScanNode):
            results[idx] = _run_scan(eng, plan, idx, plan.nodes[idx])

    waves: Dict[int, list] = {}
    for idx in join_ids:
        waves.setdefault(level[idx], []).append(idx)
    wave_list = [waves[k] for k in sorted(waves)]

    shrink_min_pad, max_syncs = _shrink_policy()
    syncs = 0
    dispatch_compacted: Dict[int, bool] = {}
    for wi, wave in enumerate(wave_list):
        for idx in wave:
            res = results[idx] = _run_join(
                eng, plan, idx, plan.nodes[idx], results, buckets, unique_joins
            )
            dispatch_compacted.setdefault(idx, res.compacted)
            if learned and not res.compacted:
                lp, was_compacted = learned.get(idx, (None, None))
                if (
                    lp is not None
                    and not was_compacted
                    and lp * _SHRINK_FACTOR <= res.pad
                ):
                    # known-size probe-shaped output: compact immediately
                    # (no sync; a stale undersized pad is caught by the
                    # final totals check and the subtree recomputes)
                    cols = _compact_probe_shaped(
                        tuple(res.cols), res.live, lp
                    )
                    results[idx] = _NodeResult(
                        list(cols), res.total_dev, lp, True, res.dicts
                    )
        is_last = wi == len(wave_list) - 1
        if (
            is_last
            or syncs >= max_syncs
            or not any(results[i].pad >= shrink_min_pad for i in wave)
        ):
            continue
        syncs += 1
        totals = fetch_bundle([results[i].total_dev for i in wave])
        for idx, t in zip(wave, (int(x) for x in totals)):
            res = results[idx]
            if res.compacted and t > res.pad:
                # overflow: children are exact (earlier waves), re-dispatch
                # this node alone with its exact bucket
                buckets[idx] = join_ops.bucket_size(t)
                res = results[idx] = _run_join(
                    eng, plan, idx, plan.nodes[idx], results, buckets,
                    unique_joins,
                )
            totals_by_node[idx] = t
            results[idx] = _shrink_node(res, t)

    # Final fetch: remaining totals + BOUNDED speculative root prefetch.
    # Shipping a root's full pow2-padded columns (MBs of padding for a
    # 5-row result) wastes transfer, while NOT prefetching costs a second
    # round trip even for tiny results. Ride only the first ``k_pad`` rows
    # (largest pow2 whose bytes fit RJT_PREFETCH_BYTES, default 256 KiB)
    # along with the totals: results that fit (the common case) finish in
    # ONE fetch; larger results pay one exact-sliced re-fetch, which they
    # needed anyway.
    import os

    prefetch_budget = int(os.environ.get("RJT_PREFETCH_BYTES", str(256 << 10)))
    for _attempt in range(max_attempts):
        fetch_ids = [i for i in join_ids if i not in totals_by_node]
        root_res = results[plan.root]
        root_arrays = tuple(d for d, _ in root_res.cols) + tuple(
            v for _, v in root_res.cols
        )
        row_bytes = max(1, sum(a.dtype.itemsize for a in root_arrays))
        full_budget = int(
            os.environ.get("RJT_PREFETCH_FULL_BYTES", str(256 << 10))
        )
        if root_res.pad * row_bytes <= full_budget:
            k_pad = root_res.pad
        else:
            k_pad = join_ops.bucket_size(1)
            while (
                k_pad * 2 <= root_res.pad
                and k_pad * 2 * row_bytes <= prefetch_budget
            ):
                k_pad *= 2
            root_arrays = _slice_cols(root_arrays, k_pad)
        flat = [results[i].total_dev for i in fetch_ids] + list(root_arrays)
        fetched = fetch_bundle(flat)
        for i, t in zip(fetch_ids, fetched):
            totals_by_node[i] = int(t)
        prefetched = (k_pad, tuple(fetched[len(fetch_ids):]))

        # residual overflow fixup (only never-synced, i.e. small, nodes)
        bad = [
            i for i in join_ids
            if results[i].compacted and totals_by_node[i] > results[i].pad
        ]
        if not bad:
            if feedback_on:
                # exact buckets for the next execution of this plan
                # (general nodes seed their bucket; probe-shaped nodes
                # compact to this pad right after dispatch)
                plan._learned_buckets = {
                    i: (
                        join_ops.bucket_size(totals_by_node[i]),
                        (i in buckets) or dispatch_compacted.get(i, True),
                    )
                    for i in join_ids
                }
            return results[plan.root], totals_by_node, prefetched
        affected = set()
        parent: Dict[int, int] = {}
        for idx in join_ids:
            j = plan.nodes[idx].data
            parent[j.left] = idx
            parent[j.right] = idx
        for b in bad:
            buckets[b] = join_ops.bucket_size(totals_by_node[b])
            n = b
            while n is not None:
                affected.add(n)
                n = parent.get(n)
        for idx in order:
            if idx in affected and isinstance(plan.nodes[idx].data, JoinNode):
                results[idx] = _run_join(
                    eng, plan, idx, plan.nodes[idx], results, buckets,
                    unique_joins,
                )
                totals_by_node.pop(idx, None)
    raise RuntimeError("plan did not converge to exact buckets")


def _run_scan(eng, plan: Plan, idx: int, node) -> _NodeResult:
    table = plan.inputs[node.data.base_table_id]
    pad = join_ops.bucket_size(table.num_rows)
    host = None
    cols, dicts = [], []
    for ci, dt in node.output_attrs:
        pcol = table.columns[ci]
        if pcol.type is not dt:
            raise TypeError(
                f"scan output attr {ci}: declared {dt}, stored {pcol.type}"
            )
        # device page decode first (raw-page upload, no host decode);
        # falls back to host decode + dense upload when ineligible
        dev = _paged_column_cached(eng, pcol, table.num_rows, pad)
        if dev is None:
            if host is None:
                host = table.to_host()
            dev = _device_column_cached(eng, host.columns[ci], pad)
        cols.append((dev.data, dev.valid))
        dicts.append(dev.dictionary)
    return _NodeResult(cols, table.num_rows, pad, True, dicts)


def _dev_col_bytes(dev) -> int:
    return (dev.data.size * dev.data.dtype.itemsize
            + dev.valid.size * dev.valid.dtype.itemsize)


import threading as _threading

#: per-owner upload serialization: concurrent warmup/precompile threads
#: racing one column's memo miss would both upload + double-charge the
#: ledger (ADVICE r3 #4). Striped by id(owner) — collisions only cost
#: spurious serialization, never correctness.
_OWNER_LOCKS = [_threading.Lock() for _ in range(64)]


def _owner_lock(owner) -> _threading.Lock:
    return _OWNER_LOCKS[id(owner) % 64]


def _memo_of(owner) -> dict:
    memo = getattr(owner, "_dev_memo", None)
    if memo is None:
        with _owner_lock(owner):
            memo = getattr(owner, "_dev_memo", None)
            if memo is None:
                memo = {}
                object.__setattr__(owner, "_dev_memo", memo)
    return memo


def _paged_column_cached(eng, pcol, num_rows: int, pad: int):
    """Device page-decode memo: one raw-page upload + on-chip decode per
    (paged column, pad) per process; ineligible columns memoize the miss
    so the alignment header scan runs once. Charged to the device ledger
    (evicted + re-decoded under memory pressure).

    Concurrency protocol (VERDICT r3 #1b / ADVICE r3 #1,#4): a memo hit
    counts only if ``touch`` confirms the ledger entry is live — touch
    atomically token-protects it against eviction through the caller's
    dispatch. The miss path first PINS the owner with a zero-byte
    ``charge`` (serializing against any in-flight eviction, which pops
    the memo and deletes buffers under the same ledger lock), re-checks
    the memo, and only then uploads — closing both the double-upload race
    and the evicted-between-get-and-dispatch use-after-free."""
    memo = _memo_of(pcol)
    dev = memo.get(pad)  # .get: a concurrent eviction may pop the key
    if dev is not None and eng.device_ledger().touch(pcol) \
            and not dev.data.is_deleted():
        return dev
    if memo.get("ineligible"):
        return None
    with _owner_lock(pcol):
        eng.device_ledger().charge(pcol, 0, eng._release_column_caches)
        dev = memo.get(pad)
        if dev is not None and not dev.data.is_deleted():
            return dev
        memo.pop(pad, None)
        dev = eng.paged_column_to_device(pcol, num_rows, pad)
        if dev is None:
            memo["ineligible"] = True
        else:
            memo[pad] = dev
            eng.device_ledger().charge(
                pcol, _dev_col_bytes(dev), eng._release_column_caches
            )
    return dev


def _device_column_cached(eng, hcol, pad: int):
    """Upload memo: one transfer per (host column, pad) per process,
    charged to the device ledger (evicted + re-uploaded under pressure).
    Same pin-first concurrency protocol as :func:`_paged_column_cached`."""
    memo = _memo_of(hcol)
    dev = memo.get(pad)
    if dev is not None and eng.device_ledger().touch(hcol) \
            and not dev.data.is_deleted():
        return dev
    with _owner_lock(hcol):
        eng.device_ledger().charge(hcol, 0, eng._release_column_caches)
        dev = memo.get(pad)
        if dev is not None and not dev.data.is_deleted():
            return dev
        memo.pop(pad, None)
        dev = eng.host_column_to_device(hcol, pad)
        memo[pad] = dev
        eng.device_ledger().charge(
            hcol, _dev_col_bytes(dev), eng._release_column_caches
        )
    return dev


def _run_join(
    eng, plan: Plan, idx: int, node, results, buckets, unique_joins
) -> _NodeResult:
    from ..engine import DevColumn

    j = node.data
    left, right = results[j.left], results[j.right]
    left_w = len(plan.nodes[j.left].output_attrs)

    if j.build_left:
        build, probe = left, right
        battr, pattr = j.left_attr, j.right_attr
    else:
        build, probe = right, left
        battr, pattr = j.right_attr, j.left_attr

    # key normalization (types, FP64 canon, VARCHAR dictionary unification)
    bd, bv = build.cols[battr]
    pd, pv = probe.cols[pattr]
    bcol = DevColumn(
        plan.nodes[j.left if j.build_left else j.right].output_attrs[battr][1],
        bd, bv, build.dicts[battr],
    )
    pcol = DevColumn(
        plan.nodes[j.right if j.build_left else j.left].output_attrs[pattr][1],
        pd, pv, probe.dicts[pattr],
    )
    keys = eng.normalize_join_keys(bcol, pcol)

    # payload wiring: which child columns feed the output
    out_sources = []  # (from_build_side?, child_col_index)
    for ci, _dt in node.output_attrs:
        side_left = ci < left_w
        child_ci = ci if side_left else ci - left_w
        from_build = side_left == j.build_left
        out_sources.append((from_build, child_ci))

    if keys is None:
        _count_path("empty_type_mismatch")
        pad = join_ops.bucket_size(0)
        zero = jnp.zeros((), jnp.int64)
        cols = []
        dicts = []
        for (fb, ci), (_, dt) in zip(out_sources, node.output_attrs):
            src = build if fb else probe
            data_dtype = src.cols[ci][0].dtype
            cols.append((
                jnp.zeros(pad, data_dtype), jnp.zeros(pad, bool)
            ))
            dicts.append(src.dicts[ci])
        return _NodeResult(cols, zero, pad, True, dicts)

    (kb, vb), (kp, vp) = keys

    bcols, bmap = [], {}
    pcols, pmap = [], {}
    for fb, ci in out_sources:
        if fb and ci not in bmap:
            bmap[ci] = len(bcols)
            bcols.append(build.cols[ci])
        if not fb and ci not in pmap:
            pmap[ci] = len(pcols)
            pcols.append(probe.cols[ci])

    unique = idx in unique_joins and bcol.dtype in (
        DataType.INT32, DataType.INT64
    )
    if unique and buckets.get(idx) is None:
        window = _unique_scatter_window(
            plan, j, battr, kb.shape[0], kp.shape[0]
        )
        if window is not None:
            _count_path("unique_scatter")
            base, r_pad = window
            out_b, found, total = _join_unique_scatter(
                kb, vb, kp, vp, _dev_scalar_i64(base), tuple(bcols), r_pad
            )
        else:
            _count_path("unique_sort")
            out_b, found, total = _join_unique(kb, vb, kp, vp, tuple(bcols))
        out_p = _mask_cols(tuple(pcols), found)
        pad = probe.pad
        compacted = False
        live = found
    else:
        out_pad = buckets.get(idx) or probe.pad
        csr = _general_csr_index(
            plan, j, battr, pattr, kb.shape[0], kp.shape[0]
        )
        if csr is not None:
            (base, counts_w, starts_w, grouped), swapped, _csr_owner = csr
            if swapped:
                # the *probe* child is the indexed scan: feed the build
                # side's keys through the kernel's probe role; the
                # kernel's bidx then addresses probe rows and its pidx
                # build rows (inner join = multiset, order-free)
                _count_path("general_csr_swapped")
                out_p2, out_b2, _live, total = _join_general_csr(
                    counts_w, starts_w, grouped, kb, vb, base,
                    tuple(pcols), tuple(bcols), out_pad,
                )
                out_b, out_p = out_b2, out_p2
            else:
                _count_path("general_csr")
                out_b, out_p, _live, total = _join_general_csr(
                    counts_w, starts_w, grouped, kp, vp, base,
                    tuple(bcols), tuple(pcols), out_pad,
                )
        else:
            dev_win = (
                _dev_csr_window(plan, j, battr, pattr,
                                kb.shape[0], kp.shape[0])
                if bcol.dtype in (DataType.INT32, DataType.INT64)
                else None
            )
            if dev_win is not None:
                swapped, base, r_pad = dev_win
                if swapped:
                    # indexed side = probe child (role swap, see the
                    # host-CSR swap above)
                    _count_path("dev_csr_swapped")
                    out_p2, out_b2, _live, total = _join_dev_csr(
                        kp, vp, kb, vb, _dev_scalar_i64(base),
                        tuple(pcols), tuple(bcols), r_pad, out_pad,
                    )
                    out_b, out_p = out_b2, out_p2
                else:
                    _count_path("dev_csr")
                    out_b, out_p, _live, total = _join_dev_csr(
                        kb, vb, kp, vp, _dev_scalar_i64(base),
                        tuple(bcols), tuple(pcols), r_pad, out_pad,
                    )
            else:
                # classify the fallback for path_stats: which gate failed?
                bchild = plan.nodes[j.left if j.build_left else j.right]
                pchild = plan.nodes[j.right if j.build_left else j.left]
                if not isinstance(bchild.data, ScanNode):
                    why = (
                        "probe_scan" if isinstance(pchild.data, ScanNode)
                        else "no_scan"
                    )
                elif bcol.dtype not in (DataType.INT32, DataType.INT64):
                    why = "non_int"
                else:
                    why = "sparse_window"
                _count_path(f"general_merge[{why}]")
                out_b, out_p, _live, total = _general_impl()(
                    kb, vb, kp, vp, tuple(bcols), tuple(pcols), out_pad
                )
        pad = out_pad
        compacted = True
        live = None

    cols, dicts = [], []
    for fb, ci in out_sources:
        cols.append(out_b[bmap[ci]] if fb else out_p[pmap[ci]])
        dicts.append((build if fb else probe).dicts[ci])
    return _NodeResult(cols, total, pad, compacted, dicts, live)


# ---------------------------------------------------------------------------
# Result extraction
# ---------------------------------------------------------------------------


def fetch_root(
    plan: Plan,
    root: _NodeResult,
    totals_by_node: Dict[int, int],
    prefetched=None,
):
    """Root columns -> HostTable (skips the transfer when the totals fetch
    already carried them — ``prefetched`` is ``(k_pad, arrays)`` holding
    the first ``k_pad`` rows, enough iff ``total <= k_pad``)."""
    from ..storage.columnar import HostTable

    root_node = plan.nodes[plan.root]
    if isinstance(root_node.data, ScanNode):
        total = plan.inputs[root_node.data.base_table_id].num_rows
    else:
        total = totals_by_node[plan.root]

    # root joins are always compacted (the engine excludes the root from
    # the unique fast path) and scans are dense, so rows [0:total) are it
    if prefetched is not None and total <= prefetched[0]:
        host_arrays = prefetched[1]
    else:
        arrays = tuple(d for d, _ in root.cols) + tuple(
            v for _, v in root.cols
        )
        fetch_pad = min(join_ops.bucket_size(max(total, 1)), root.pad)
        if fetch_pad < root.pad:
            arrays = _slice_cols(arrays, fetch_pad)
        host_arrays = fetch_bundle(list(arrays))
    k = len(root.cols)
    datas, valids = host_arrays[:k], host_arrays[k:]

    cols = []
    for (ci, dt), data, valid, d in zip(
        root_node.output_attrs, datas, valids, root.dicts
    ):
        cols.append(_np_column_to_host(dt, data[:total], valid[:total], d))
    return HostTable(total, cols)


def _np_column_to_host(dt, data, valid, dictionary):
    from ..storage.columnar import HostColumn, StringDict, gather_varlen

    data = np.asarray(data)
    valid = np.asarray(valid)
    if dt is DataType.VARCHAR:
        d = dictionary or StringDict.empty()
        if len(data) == 0 or d.size == 0:
            return HostColumn.varchar(
                np.zeros(0, np.uint8), np.zeros(len(data), np.int64), valid
            )
        ids = np.clip(data, 0, d.size - 1)
        starts = np.where(valid, d.starts[ids], 0)
        lengths = np.where(valid, d.lengths[ids], 0)
        heap, ends = gather_varlen(d.heap, starts, lengths)
        return HostColumn.varchar(heap, ends, valid)
    if dt is DataType.FP64:
        return HostColumn(dt, data.view(np.float64), valid)
    return HostColumn(dt, data, valid)


def execute_shared(plan: Plan, unique_joins: frozenset):
    """Full shape-shared execution: returns a HostTable."""
    root, totals, prefetched = run_plan(plan, unique_joins)
    return fetch_root(plan, root, totals, prefetched)
