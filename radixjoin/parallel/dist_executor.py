"""Distributed whole-plan execution over a device mesh.

Runs an entire :class:`~radixjoin.plan.ir.Plan` (the same IR the
single-chip engine executes, reference include/plan.h:27-149) SPMD over a
1-D device mesh: every base table is row-sharded across the mesh, every
join is the hash-partitioned all-to-all shuffle join (dist_join.py) with
skew-aware heavy-hitter broadcast, and **intermediates never leave the
mesh** — a join's sharded output columns feed the next join's shuffle
directly, so the only host syncs are one count-phase total per join and
the final result gather.

The reference has no distribution at all (single process + OpenMP,
SURVEY.md §2 checklist); this is the plan-level form of the new
capability mandated by BASELINE.json's north star (multi-host shuffle
join). On a GPU host the mesh axis spans the cards and XLA lowers the
collectives to NCCL over NVLink; the same code runs unchanged across
processes (parallel/multihost.py).

Semantics match the single-chip engine exactly (NULL keys never match,
duplicate fan-out, type-mismatch => empty, NULL payloads flow through —
src/execute.cpp:62-83, :232-243): ``tests/test_distributed.py`` checks
full JOB plans on an 8-device CPU mesh against the sqlite oracle.

VARCHAR join keys are unified on the host (``np.unique`` over the two
sides' dictionaries, like the single-chip engine) into one joint id
space, then joined as i64 ids on the mesh; VARCHAR payloads flow through
as dictionary ids and rehydrate at the final gather.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import DataType
from ..plan.ir import Plan, ScanNode
from ..storage.columnar import HostColumn, HostTable, StringDict, gather_varlen
from .dist_join import (
    DistJoinConfig,
    _pad_to_shards,
    detect_hot_keys,
    distributed_join_deferred,
    distributed_join_device,
)
from . import multihost
from .mesh import make_mesh, shard_axis
from ..ops import keynorm


@dataclasses.dataclass
class _NodeRes:
    """One executed plan node on the mesh: per-output-attr sharded
    (data, valid) pairs, a sharded row-liveness mask, exact row total,
    and per-attr dictionary provenance (VARCHAR)."""

    cols: List[Tuple]  # [(data, valid), ...] sharded along the mesh axis
    live: object  # sharded bool, or None (scan: validity == liveness)
    total: int
    dicts: List[Optional[StringDict]]


# Distributed cardinality feedback: (plan content key, node idx) ->
# learned static join config + hot keys + totals from a cold run. A warm
# repeat replays every join sync-free (distributed_join_deferred) and
# validates ALL joins in one batched fetch at the plan root; any
# deviation (data changed under the same shape, overflow, different
# totals) evicts the plan's entries and reruns cold. Every process
# learns identical state from identically-replicated fetches, so
# multi-process ranks take the same warm/cold decision in lockstep.
_DIST_FEEDBACK: Dict[tuple, dict] = {}


def _plan_key(plan: Plan) -> str:
    from .. import engine as eng

    return eng._FeedbackStore._key(plan)


def _fb_base_key(plan: Plan, mesh, config: DistJoinConfig) -> tuple:
    """Learned state is only replayable under the SAME mesh and join
    config — a different chunk count, bloom size or device count must
    miss the cache, not silently replay the old configuration."""
    return (_plan_key(plan), id(mesh), dataclasses.astuple(config))


_FEEDBACK_CAP = 512  # FIFO-evict beyond this many (plan, join) entries


def _fb_store(key: tuple, info: dict) -> None:
    if len(_DIST_FEEDBACK) >= _FEEDBACK_CAP:
        _DIST_FEEDBACK.pop(next(iter(_DIST_FEEDBACK)))
    _DIST_FEEDBACK[key] = info


_F64_KEY_FN = None


def _canon_f64_keys(bits, valid):
    """FP64 join-key canonicalization on the mesh: -0.0 == +0.0, NaN never
    matches. Applied only to the key view at join time — stored FP64
    columns keep raw bits so NaN/-0.0 *payloads* survive to the output
    (reference semantics: NULL-drop applies to keys, src/execute.cpp:62-83,
    while payload values flow through untouched)."""
    global _F64_KEY_FN
    if _F64_KEY_FN is None:
        _F64_KEY_FN = jax.jit(keynorm.canon_f64_bits)
    return _F64_KEY_FN(bits, valid)


def _shard_scan(plan: Plan, node, mesh) -> _NodeRes:
    """Row-shard one base table's projected columns across the mesh."""
    table = plan.inputs[node.data.base_table_id]
    host = table.to_host()
    ndev = mesh.devices.size
    sharding = shard_axis(mesh)
    n = host.num_rows
    cols, dicts = [], []
    live_np = _pad_to_shards(np.ones(max(n, 1), dtype=bool), ndev, fill=False)
    if n == 0:
        live_np[:] = False

    put = lambda a: multihost.put_sharded(a, sharding)  # noqa: E731
    for ci, dt in node.output_attrs:
        col = host.columns[ci]
        if col.dtype is not dt:
            raise TypeError(
                f"scan output attr {ci}: declared {dt}, stored {col.dtype}"
            )
        valid = col.valid
        if dt is DataType.VARCHAR:
            from .. import engine as eng

            dev = eng.host_column_to_device(col, max(n, 1))
            data = np.asarray(dev.data)[: max(n, 1)]
            dicts.append(dev.dictionary)
        elif dt is DataType.FP64:
            data = col.values.view(np.int64)  # raw bits; keys canonicalized at join time
            dicts.append(None)
        else:
            data = col.values
            dicts.append(None)
        data = _pad_to_shards(np.asarray(data), ndev)
        v = _pad_to_shards(valid.astype(bool), ndev, fill=False)
        if n == 0:
            v[:] = False
        cols.append((put(data), put(v)))
    return _NodeRes(cols, put(live_np), n, dicts)


def _empty_res(output_attrs, mesh) -> _NodeRes:
    ndev = mesh.devices.size
    sharding = shard_axis(mesh)
    pad = ndev * 16
    put = lambda a: multihost.put_sharded(a, sharding)  # noqa: E731
    cols, dicts = [], []
    for _, dt in output_attrs:
        npdt = np.int64 if dt in (DataType.INT64, DataType.FP64) else np.int32
        cols.append((put(np.zeros(pad, npdt)), put(np.zeros(pad, bool))))
        dicts.append(StringDict.empty() if dt is DataType.VARCHAR else None)
    return _NodeRes(cols, put(np.zeros(pad, bool)), 0, dicts)


_REMAP_FN = None


def _unify_varchar_keys(kb, kp, db, dp, mesh):
    """Remap both sides' dictionary ids onto one joint id space so i64
    equality == string equality — the distributed form of the single-chip
    engine's ``_unify_dictionaries`` (engine.py). Unification is a host
    ``np.unique`` over the two (small) dictionaries; the resulting LUTs
    are replicated across the mesh and the sharded id columns are
    remapped elementwise, so no reshard of the key columns happens."""
    ob = db.objects() if db is not None else np.empty(0, object)
    op = dp.objects() if dp is not None else np.empty(0, object)
    if not (len(ob) and len(op)):
        # one side has no string values at all: no id can match; rows on
        # that side are already invalid, so the raw ids are fine
        return kb, kp
    rb, rp, _ = keynorm.joint_id_inverse(ob, op)
    rep = multihost.put_sharded  # replicated upload below
    from .mesh import replicated

    lut_b = rep(rb.astype(np.int64), replicated(mesh))
    lut_p = rep(rp.astype(np.int64), replicated(mesh))

    global _REMAP_FN
    if _REMAP_FN is None:
        _REMAP_FN = jax.jit(
            lambda lut, ids: lut[jnp.clip(ids, 0, lut.shape[0] - 1)]
        )
    return _REMAP_FN(lut_b, kb), _REMAP_FN(lut_p, kp)


def _join_node(
    plan: Plan, node, left: _NodeRes, right: _NodeRes, mesh,
    config: DistJoinConfig,
    fb_key: Optional[tuple] = None,
    checks: Optional[list] = None,
) -> _NodeRes:
    j = node.data
    if left.total == 0 or right.total == 0:
        return _empty_res(node.output_attrs, mesh)

    lt = plan.nodes[j.left].output_attrs[j.left_attr][1]
    rt = plan.nodes[j.right].output_attrs[j.right_attr][1]
    if lt is not rt:
        return _empty_res(node.output_attrs, mesh)

    if j.build_left:
        build, probe = left, right
        battr, pattr = j.left_attr, j.right_attr
    else:
        build, probe = right, left
        battr, pattr = j.right_attr, j.left_attr

    def side_args(res: _NodeRes, attr: int, prefix: str):
        kd, kv = res.cols[attr]
        kv = kv if res.live is None else kv & res.live
        payloads = {}
        for i, (d, v) in enumerate(res.cols):
            payloads[f"{prefix}{i}"] = d
            payloads[f"{prefix}v{i}"] = (
                v if res.live is None else v & res.live
            )
        return kd.astype(jnp.int64), kv, payloads

    kb, vb, bpl = side_args(build, battr, "b")
    kp, vp, ppl = side_args(probe, pattr, "p")
    if lt is DataType.VARCHAR:
        kb, kp = _unify_varchar_keys(
            kb, kp, build.dicts[battr], probe.dicts[pattr], mesh
        )
    elif lt is DataType.FP64:
        kb, vb = _canon_f64_keys(kb, vb)
        kp, vp = _canon_f64_keys(kp, vp)

    fb = _DIST_FEEDBACK.get(fb_key) if fb_key is not None else None
    if fb is not None:
        # warm replay: zero host syncs — learned hot keys, capacities and
        # output bucket; validation deferred to the plan-root batch check
        total = int(fb["totals"].sum())
        columns, live, totals_dev, overflow_dev = distributed_join_deferred(
            kb, vb, bpl, kp, vp, ppl, mesh,
            fb["hot_keys"], fb["hot_valid"], config, fb,
            expand=total > 0,  # learned-empty: checks only, no materialize
        )
        checks.append((totals_dev, overflow_dev, fb["totals"]))
        if total == 0:
            return _empty_res(node.output_attrs, mesh)
    else:
        # heavy-hitter detection samples the probe side; the keys live on
        # the mesh, so subsample device-side (strided), fetch the sample
        ndev = mesh.devices.size
        pl = kp.shape[0] // ndev
        # chunked exchange: a key's rows land in a 1/chunks-sized slab
        chunks = max(1, int(config.exchange_chunks))
        cap_p = max(16, int(config.capacity_factor * pl
                            / (ndev * chunks)) + 1)
        stride = max(1, kp.shape[0] // config.sample_size)
        # the strided subsample under-counts population frequency by
        # `stride`; scaling the detector's capacity compensates exactly
        sample_k, sample_v = multihost.fetch_many(
            (kp[::stride], vp[::stride]), mesh)
        hot_keys, hot_valid = detect_hot_keys(
            np.asarray(sample_k), np.asarray(sample_v),
            config, ndev, max(1, cap_p // stride),
        )

        info: dict = {}
        columns, live, totals = distributed_join_device(
            kb, vb, bpl, kp, vp, ppl, mesh, hot_keys, hot_valid, config,
            info_out=info,
        )
        if fb_key is not None:
            info.update(hot_keys=hot_keys, hot_valid=hot_valid,
                        totals=np.asarray(totals))
            _fb_store(fb_key, info)
        total = int(np.sum(totals))  # host array: fetched by the ladder
        if total == 0:
            return _empty_res(node.output_attrs, mesh)

    bname = "b" if j.build_left else "p"
    rname = "p" if j.build_left else "b"
    left_w = len(left.cols)
    cols, dicts = [], []
    for ci, dt in node.output_attrs:
        if ci < left_w:
            prefix, child, cc = bname, left, ci
        else:
            prefix, child, cc = rname, right, ci - left_w
        data = columns[f"{prefix}.{prefix}{cc}"]
        valid = columns[f"{prefix}.{prefix}v{cc}"] & live
        cols.append((data, valid))
        dicts.append(child.dicts[cc])
    return _NodeRes(cols, live, total, dicts)


def execute_distributed(
    plan: Plan,
    mesh=None,
    config: Optional[DistJoinConfig] = None,
) -> HostTable:
    """Evaluate ``plan`` across the mesh; gather the root to a HostTable."""
    plan.validate()
    mesh = mesh or make_mesh()
    config = config or DistJoinConfig()

    key = _fb_base_key(plan, mesh, config) if config.feedback else None
    checks: list = []
    results: Dict[int, _NodeRes] = {}
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            results[idx] = _shard_scan(plan, node, mesh)
        else:
            results[idx] = _join_node(
                plan, node,
                results[node.data.left], results[node.data.right],
                mesh, config,
                fb_key=key + (idx,) if key is not None else None,
                checks=checks,
            )

    if checks:
        # one batched fetch validates every warm-replayed join: exact iff
        # no shuffle overflowed and every join produced the totals the
        # replay planned with (a changed dataset under the same plan
        # shape, or grown skew, fails here and reruns cold)
        fetched = multihost.fetch_many(
            [(t, o) for t, o, _ in checks], mesh)
        ok = all(
            int(np.max(o)) == 0 and np.array_equal(np.asarray(t), learned)
            for (t, o), (_, _, learned) in zip(fetched, checks)
        )
        if not ok:
            for idx in plan.topo_order():
                _DIST_FEEDBACK.pop(key + (idx,), None)
            # rerun with feedback still on: every entry for this plan is
            # gone, so the rerun takes the cold path — and re-learns,
            # sparing the NEXT execution a third full cold pass
            return execute_distributed(plan, mesh=mesh, config=config)

    root = results[plan.root]
    root_node = plan.nodes[plan.root]
    n = root.total
    # batched gather: live mask + every root column in one transfer
    fetched_cols = multihost.fetch_many(
        ([] if root.live is None else [root.live])
        + [a for dv in root.cols for a in dv], mesh)
    if root.live is None:
        live_np = np.zeros(0, bool)  # scan root: slice below
        flat = fetched_cols
    else:
        live_np = np.asarray(fetched_cols[0])
        flat = fetched_cols[1:]
    cols: List[HostColumn] = []
    for k, (ci, dt) in enumerate(root_node.output_attrs):
        data_h, valid_h = flat[2 * k], flat[2 * k + 1]
        if root.live is None:
            values = np.asarray(data_h)[:n]
            valid = np.asarray(valid_h)[:n]
        else:
            values = np.asarray(data_h)[live_np]
            valid = np.asarray(valid_h)[live_np]
        if dt is DataType.VARCHAR:
            d = root.dicts[k] or StringDict.empty()
            if len(values) == 0 or d.size == 0:
                cols.append(HostColumn.varchar(
                    np.zeros(0, np.uint8),
                    np.zeros(len(values), np.int64),
                    valid,
                ))
            else:
                ids = np.clip(values, 0, d.size - 1)
                starts = np.where(valid, d.starts[ids], 0)
                lengths = np.where(valid, d.lengths[ids], 0)
                heap, ends = gather_varlen(d.heap, starts, lengths)
                cols.append(HostColumn.varchar(heap, ends, valid))
        elif dt is DataType.FP64:
            cols.append(HostColumn(
                dt, np.asarray(values, np.int64).view(np.float64), valid
            ))
        else:
            cols.append(HostColumn(dt, values.astype(dt.numpy_dtype), valid))
    return HostTable(n, cols)
