"""Plan execution engine.

Topologically walks a :class:`~radixjoin.plan.ir.Plan` and evaluates it
over dense device arrays (the reference interprets the same tree over
row-variant vectors, src/execute.cpp:302-314). Equivalent public surface to
the reference contract (include/plan.h:337-344):

    ctx = build_context(); result = execute(plan, ctx); destroy_context(ctx)

Data model on device:
  * every column is (data, valid) — ``data`` int32/int64 (FP64 is carried as
    bitcast int64, so key equality is bit-exact and the bits round-trip
    exactly), ``valid`` bool;
  * VARCHAR columns are dictionary-encoded: int32 ids on device plus a
    host-side sorted dictionary of ``bytes`` (strings are only ever compared
    for equality in joins, so id equality after dictionary unification is
    exact);
  * arrays are padded to pow2 buckets, padding rows have ``valid = False``.

Join semantics replicated from the reference:
  * inner equi-join, NULL keys never match (src/execute.cpp:62-83);
  * duplicate keys fan out (one output row per matching build row,
    src/execute.cpp:232-243);
  * if either child is empty the join is empty (src/execute.cpp:50);
  * a key-type mismatch between the two sides yields an empty join — the
    reference extracts keys via variant type-match, so a probe value of a
    different alternative never matches (src/execute.cpp:75-83);
  * output column ``ci`` of a join reads left-child output ``ci`` when
    ``ci < left_width`` else right-child output ``ci - left_width``
    (src/execute.cpp:238-241).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .dtypes import DataType
from .ops import join as join_ops
from .ops import keynorm
from .plan.ir import JoinNode, Plan, ScanNode
from .storage import native
from .storage.columnar import (
    Column,
    ColumnarTable,
    HostColumn,
    HostTable,
    StringDict,
    gather_varlen,
)
from .storage import page as page_codec



@dataclasses.dataclass
class DevColumn:
    """One dense device column + validity, padded to the table bucket."""

    dtype: DataType
    data: jnp.ndarray
    valid: jnp.ndarray
    dictionary: Optional[StringDict] = None  # sorted distinct values (VARCHAR)


@dataclasses.dataclass
class DevTable:
    num_rows: int  # exact row count; arrays are padded beyond it
    columns: List[DevColumn]

    @property
    def padded_rows(self) -> int:
        return 0 if not self.columns else int(self.columns[0].data.shape[0])


class Context:
    """Engine context (reference build_context/destroy_context).

    Holds nothing critical today; exists so harnesses can carry caches and
    device/mesh configuration across queries.
    """

    def __init__(self, device=None):
        self.device = device


def build_context() -> Context:
    return Context()


def destroy_context(context: Optional[Context]) -> None:
    _feedback_store().save()
    return None


class _FeedbackStore:
    """Cross-process persistence of cardinality feedback.

    Learned per-join exact buckets and root row counts (the state the
    fused executor re-specializes programs with on repeat executions)
    keyed by a content hash of the plan *and its input row counts* — a
    fresh process skips the overflow-retry/default-bucket pass entirely
    and compiles only the learned-shape programs (which the persistent
    XLA compile cache already holds). Stored as one JSON next to the
    compile cache; stale entries are harmless (an undersized learned pad
    just falls back to the normal overflow retry). RJT_FEEDBACK_PERSIST=off
    disables; no jax compilation cache dir configured also disables.
    """

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._data = None  # lazily loaded {key: [buckets, root_rows]}
        self._dirty = False

    def _path(self):
        import os

        if os.environ.get("RJT_FEEDBACK_PERSIST", "on") == "off":
            return None
        p = os.environ.get("RJT_FEEDBACK_PATH")
        if p:
            return p
        cache_dir = jax.config.jax_compilation_cache_dir
        if not cache_dir:
            return None
        return os.path.join(cache_dir, "rjt_feedback.json")

    def _load(self):
        import json
        import os

        if self._data is not None:
            return self._data
        path = self._path()
        self._data = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._data = json.load(f)
            except (OSError, ValueError):
                pass
        return self._data

    @staticmethod
    def _key(plan: Plan) -> str:
        key = getattr(plan, "_feedback_key", None)
        if key is None:
            import hashlib

            desc = []
            for node in plan.nodes:
                attrs = tuple((c, int(dt)) for c, dt in node.output_attrs)
                if isinstance(node.data, ScanNode):
                    desc.append(("s", node.data.base_table_id, attrs))
                else:
                    j = node.data
                    desc.append((
                        "j", j.build_left, j.left, j.right,
                        j.left_attr, j.right_attr, attrs,
                    ))
            rows = tuple(t.num_rows for t in plan.inputs)
            blob = repr((desc, rows, plan.root)).encode()
            key = hashlib.sha1(blob).hexdigest()
            plan._feedback_key = key
        return key

    def load_into(self, plan: Plan) -> None:
        if self._path() is None:
            return
        with self._lock:
            hit = self._load().get(self._key(plan))
        if hit:
            buckets, root = hit
            plan._learned_buckets = {
                int(i): (int(pad), bool(comp))
                for i, (pad, comp) in buckets.items()
            }
            if root is not None:
                plan._learned_root_rows = int(root)

    def put(self, plan: Plan) -> None:
        if self._path() is None:
            return
        buckets = {
            str(i): [int(pad), bool(comp)]
            for i, (pad, comp) in plan._learned_buckets.items()
        }
        entry = [buckets, getattr(plan, "_learned_root_rows", None)]
        with self._lock:
            data = self._load()
            if data.get(self._key(plan)) != entry:
                data[self._key(plan)] = entry
                self._dirty = True

    def save(self) -> None:
        import json
        import os

        path = self._path()
        with self._lock:
            if not (path and self._dirty and self._data is not None):
                return
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(self._data, f)
                os.replace(tmp, path)
                self._dirty = False
            except OSError:
                pass


_FEEDBACK: Optional[_FeedbackStore] = None


def _feedback_store() -> _FeedbackStore:
    global _FEEDBACK
    if _FEEDBACK is None:
        _FEEDBACK = _FeedbackStore()
        import atexit

        atexit.register(_FEEDBACK.save)
    return _FEEDBACK


# ---------------------------------------------------------------------------
# Host <-> device column conversion
# ---------------------------------------------------------------------------


def host_column_to_device(col: HostColumn, pad: int) -> DevColumn:
    n = len(col.valid)
    valid = np.zeros(pad, dtype=bool)
    valid[:n] = col.valid
    if col.dtype is DataType.VARCHAR:
        res = native.dict_encode(col.heap, col.ends, col.valid)
        ids = np.zeros(pad, dtype=np.int32)
        if res is not None:
            row_ids, dheap, dends = res
            ids[:n] = row_ids
            dictionary = StringDict(dheap, dends)
        else:
            present = col.objects()[col.valid]
            if len(present):
                uniq, inverse = np.unique(present, return_inverse=True)
            else:
                uniq, inverse = np.empty(0, dtype=object), np.zeros(0, np.int64)
            ids[:n][col.valid] = inverse.astype(np.int32)
            dictionary = StringDict.from_objects(list(uniq))
        return DevColumn(col.dtype, jnp.asarray(ids), jnp.asarray(valid), dictionary)
    if col.dtype is DataType.FP64:
        bits = np.zeros(pad, dtype=np.int64)
        bits[:n] = col.values.view(np.int64)
        return DevColumn(col.dtype, jnp.asarray(bits), jnp.asarray(valid))
    data = np.zeros(pad, dtype=col.dtype.numpy_dtype)
    data[:n] = col.values
    return DevColumn(col.dtype, jnp.asarray(data), jnp.asarray(valid))


def device_column_to_host(col: DevColumn, num_rows: int) -> HostColumn:
    data = np.asarray(col.data)[:num_rows]
    valid = np.asarray(col.valid)[:num_rows]
    if col.dtype is DataType.VARCHAR:
        d = col.dictionary or StringDict.empty()
        if num_rows == 0 or d.size == 0:
            return HostColumn.varchar(
                np.zeros(0, np.uint8),
                np.zeros(num_rows, np.int64),
                valid,
            )
        ids = np.clip(data, 0, d.size - 1)
        dict_starts = d.starts
        dict_lengths = d.lengths
        starts = np.where(valid, dict_starts[ids], 0)
        lengths = np.where(valid, dict_lengths[ids], 0)
        heap, ends = gather_varlen(d.heap, starts, lengths)
        return HostColumn.varchar(heap, ends, valid)
    if col.dtype is DataType.FP64:
        return HostColumn(col.dtype, data.view(np.float64), valid)
    return HostColumn(col.dtype, data, valid)


def paged_column_to_device(pcol, num_rows: int, pad: int) -> Optional[DevColumn]:
    """Upload the RAW pages and decode on device (VERDICT r1 #4).

    Returns None when the column is not eligible (VARCHAR — dictionary
    building is host-bound — or pages not row-aligned, e.g. the greedy
    reference-parity encoder, or RJT_DEVICE_DECODE=off); callers fall
    back to the host decode + dense upload. Replaces the host decode of
    reference src/build_table.cpp:306-436 with on-chip header/bitmap/rank
    decode (storage/device_decode.py)."""
    from .storage import device_decode as dd

    if not dd.enabled() or pcol.type not in dd.ALIGNED_ROWS:
        return None
    if callable(pcol._pages):
        # lazily-deferred encode (harness/bench path): the dense host
        # arrays already exist and upload directly — forcing a page
        # encode just to decode it back on device would add work
        return None
    pages = pcol.pages
    if dd.aligned_full_pages(pages, num_rows, pcol.type) is None:
        return None
    data, valid = dd.decode_fixed_device(pages, num_rows, pcol.type)
    if pad > num_rows:
        data = jnp.concatenate(
            [data, jnp.zeros(pad - num_rows, dtype=data.dtype)]
        )
        valid = jnp.concatenate(
            [valid, jnp.zeros(pad - num_rows, dtype=bool)]
        )
    return DevColumn(pcol.type, data, valid)


def host_table_to_device(table: HostTable) -> DevTable:
    pad = join_ops.bucket_size(table.num_rows)
    return DevTable(
        table.num_rows, [host_column_to_device(c, pad) for c in table.columns]
    )


def device_table_to_host(table: DevTable) -> HostTable:
    return HostTable(
        table.num_rows,
        [device_column_to_host(c, table.num_rows) for c in table.columns],
    )


# ---------------------------------------------------------------------------
# Join key normalization
# ---------------------------------------------------------------------------


def _canonicalize_f64_key(data: jnp.ndarray, valid: jnp.ndarray):
    """FP64 join-key equality on bitcast int64.

    ``-0.0 == +0.0`` must match (canonicalize the bit pattern) and
    ``NaN != NaN`` must never match (NaN keys become invalid) — this is what
    the reference's ``slot_key[h] != key`` over doubles does
    (src/execute.cpp:215, :231).
    """
    return keynorm.canon_f64_bits(data, valid)


def _unify_dictionaries(a: DevColumn, b: DevColumn):
    """Map two dictionary-encoded columns onto one joint id space (exact)."""
    da = a.dictionary.objects() if a.dictionary is not None else np.empty(0, object)
    db = b.dictionary.objects() if b.dictionary is not None else np.empty(0, object)
    ra, rb, _ = keynorm.joint_id_inverse(da, db)
    map_a, map_b = jnp.asarray(ra), jnp.asarray(rb)

    def remap(col, mapping):
        if mapping.shape[0] == 0:
            return jnp.zeros_like(col.data)
        ids = jnp.clip(col.data, 0, mapping.shape[0] - 1)
        return mapping[ids]

    return remap(a, map_a), remap(b, map_b)


def normalize_join_keys(build: DevColumn, probe: DevColumn):
    """Produce comparable (key, valid) pairs for both sides.

    Returns None when the column types cannot match under the reference's
    variant-extraction semantics (the join result is then empty).
    """
    bt, pt = build.dtype, probe.dtype
    if bt is not pt:
        return None
    if bt is DataType.VARCHAR:
        kb, kp = _unify_dictionaries(build, probe)
        return (kb, build.valid), (kp, probe.valid)
    if bt is DataType.FP64:
        kb, vb = _canonicalize_f64_key(build.data, build.valid)
        kp, vp = _canonicalize_f64_key(probe.data, probe.valid)
        return (kb, vb), (kp, vp)
    return (build.data, build.valid), (probe.data, probe.valid)


# ---------------------------------------------------------------------------
# Node execution
# ---------------------------------------------------------------------------


def _execute_scan(input_table: ColumnarTable, output_attrs) -> DevTable:
    """Decode the paged input and project ``output_attrs``.

    (Reference: Table::from_columnar + per-record projection,
    src/execute.cpp:284-300 — here projection is column selection, free.)
    Row-aligned fixed-width columns upload raw pages and decode on chip;
    others decode on the host and upload dense.
    """
    pad = join_ops.bucket_size(input_table.num_rows)
    host = None
    cols = []
    for col_idx, dt in output_attrs:
        pcol = input_table.columns[col_idx]
        if pcol.type is not dt:
            raise TypeError(
                f"scan output attr {col_idx}: declared {dt}, stored {pcol.type}"
            )
        col = paged_column_to_device(pcol, input_table.num_rows, pad)
        if col is None:
            if host is None:
                host = input_table.to_host()
            col = host_column_to_device(host.columns[col_idx], pad)
        cols.append(col)
    return DevTable(input_table.num_rows, cols)


def _empty_result(output_attrs) -> DevTable:
    pad = join_ops.bucket_size(0)
    cols = []
    for _, dt in output_attrs:
        data_dtype = np.int32 if dt in (DataType.INT32, DataType.VARCHAR) else np.int64
        cols.append(
            DevColumn(
                dt,
                jnp.zeros(pad, dtype=data_dtype),
                jnp.zeros(pad, dtype=bool),
                StringDict.empty() if dt is DataType.VARCHAR else None,
            )
        )
    return DevTable(0, cols)


def _execute_join(left: DevTable, right: DevTable, join: JoinNode, output_attrs) -> DevTable:
    if left.num_rows == 0 or right.num_rows == 0:
        return _empty_result(output_attrs)

    if join.build_left:
        build, probe = left, right
        build_attr, probe_attr = join.left_attr, join.right_attr
    else:
        build, probe = right, left
        build_attr, probe_attr = join.right_attr, join.left_attr

    keys = normalize_join_keys(build.columns[build_attr], probe.columns[probe_attr])
    if keys is None:
        return _empty_result(output_attrs)
    (kb, vb), (kp, vp) = keys

    bidx, pidx, live, total = join_ops.join_count_and_index(kb, vb, kp, vp)
    if total == 0:
        return _empty_result(output_attrs)

    lidx = bidx if join.build_left else pidx
    ridx = pidx if join.build_left else bidx

    left_w = len(left.columns)
    out_cols: List[DevColumn] = []
    for ci, dt in output_attrs:
        if ci < left_w:
            src, idx = left.columns[ci], lidx
        else:
            src, idx = right.columns[ci - left_w], ridx
        [(data, valid)] = join_ops.gather_columns([(src.data, src.valid)], idx, live)
        out_cols.append(DevColumn(dt, data, valid, src.dictionary))
    return DevTable(total, out_cols)


def execute_device(plan: Plan, context: Optional[Context] = None) -> DevTable:
    """Run the plan, returning the root as a dense device table."""
    plan.validate()
    results = {}
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            results[idx] = _execute_scan(
                plan.inputs[node.data.base_table_id], node.output_attrs
            )
        else:
            results[idx] = _execute_join(
                results[node.data.left],
                results[node.data.right],
                node.data,
                node.output_attrs,
            )
    return results[plan.root]


# ---------------------------------------------------------------------------
# Fused whole-plan execution (one H2D, one program, one D2H per query)
# ---------------------------------------------------------------------------

import functools as _functools


@_functools.partial(jax.jit, static_argnames=("n",))
def _slice_columns(arrays, n: int):
    return tuple(a[:n] for a in arrays)


def _detect_unique_joins(plan: Plan) -> frozenset:
    """Join nodes whose build side is a scan column with verified-unique
    valid keys (FK->PK). The root is excluded: unique-join output is
    probe-shaped/uncompacted, and the result extraction slices the root to
    ``[:total]`` which assumes compacted rows."""
    unique = set()
    for idx, node in enumerate(plan.nodes):
        if idx == plan.root or not isinstance(node.data, JoinNode):
            continue
        j = node.data
        build_child = plan.nodes[j.left if j.build_left else j.right]
        if not isinstance(build_child.data, ScanNode):
            continue
        battr = j.left_attr if j.build_left else j.right_attr
        col_idx, dt = build_child.output_attrs[battr]
        if dt not in (DataType.INT32, DataType.INT64):
            continue
        host = plan.inputs[build_child.data.base_table_id].to_host()
        if host.columns[col_idx].is_unique_key():
            unique.add(idx)
    return frozenset(unique)


import threading
import weakref

#: plans carrying a ``_fused_struct_cache`` (holds refs to cached device
#: columns; must be dropped whenever the ledger evicts anything so an
#: evicted buffer can actually be freed)
_DEVICE_CACHE_PLANS: dict = {}


def _register(registry: dict, obj) -> None:
    key = id(obj)
    if key not in registry:
        registry[key] = weakref.ref(obj, lambda _r, k=key: registry.pop(k, None))


def register_device_cache_plan(plan) -> None:
    _register(_DEVICE_CACHE_PLANS, plan)


def _drop_fused_struct_caches() -> None:
    for ref in list(_DEVICE_CACHE_PLANS.values()):
        plan = ref()
        if plan is not None:
            plan._fused_struct_cache = None


def _delete_array(a) -> None:
    """Explicitly free a device buffer (deterministic, not GC-timed).
    In-flight executions keep their own usage holds, so deleting a cached
    input that a dispatched program still reads is safe."""
    try:
        a.delete()
    except Exception:  # noqa: BLE001 - best-effort (already deleted, CPU)
        pass


class _LedgerEntry:
    __slots__ = ("ref", "nbytes", "seq", "release", "users")

    def __init__(self, ref, nbytes, seq, release):
        self.ref = ref  # weakref to the owning host object
        self.nbytes = nbytes
        self.seq = seq
        self.release = release
        self.users: set = set()  # active query tokens that touched this


class DeviceLedger:
    """Deterministic device-memory accounting.

    Cross-query pinned caches (column upload memos, CSR indexes, VARCHAR
    remaps) would otherwise accumulate past device memory and leave the
    OOM retry ladder racing the runtime's asynchronous deallocation. This
    ledger replaces that race with bookkeeping:

    * every cross-query cache upload **charges** its exact byte count and
      a release callback;
    * before a query dispatches, :meth:`reserve` admits it only once
      ``idle-pinned + active reservations + estimate <= budget``, evicting
      least-recently-used *idle* entries (explicit ``.delete()``, no GC
      timing) to make room — entries touched by an in-flight query are
      never evicted;
    * concurrent queries (the bench warmup pool, ``execute_many``) are
      admission-controlled: a query that cannot fit next to the in-flight
      set blocks until one finishes (or runs alone as a best-effort
      backstop).

    The reference has no analogue (a 512 GB shared-memory host never
    tracked its working set); this is the HBM-tier equivalent of its
    L2-sized radix buckets (src/execute.cpp:86-92).
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._entries: dict = {}  # id(owner) -> _LedgerEntry
        self._reservations: dict = {}  # token -> bytes
        self._seq = 0
        self._local = threading.local()
        self.stats = {"evictions": 0, "evicted_bytes": 0, "waits": 0,
                      "charged_bytes": 0}

    # -- token context ----------------------------------------------------

    def _tokens(self) -> list:
        toks = getattr(self._local, "tokens", None)
        if toks is None:
            toks = self._local.tokens = []
        return toks

    def activate(self, token):
        """Context manager: attribute charges/touches on this thread to
        ``token`` (execute_many interleaves many queries on one thread)."""
        ledger = self

        class _Ctx:
            def __enter__(self):
                ledger._tokens().append(token)

            def __exit__(self, *exc):
                ledger._tokens().pop()

        return _Ctx()

    # -- charging ---------------------------------------------------------

    def charge(self, owner, nbytes: int, release) -> None:
        """Record ``nbytes`` of device memory pinned by ``owner`` (adds to
        any previous charge for the same owner). ``release(owner)`` must
        free every device buffer the owner caches."""
        key = id(owner)
        with self._cond:
            e = self._entries.get(key)
            if e is None:
                ref = weakref.ref(owner, lambda _r, k=key: self._forget(k))
                e = self._entries[key] = _LedgerEntry(ref, 0, 0, release)
            e.nbytes += int(nbytes)
            self.stats["charged_bytes"] += int(nbytes)  # cumulative H2D
            self._seq += 1
            e.seq = self._seq
            e.users.update(self._tokens())

    def touch(self, owner) -> bool:
        """LRU-touch ``owner``'s entry and attribute it to the thread's
        active query token (protecting it from eviction for the rest of
        the query). Returns False when the entry is GONE — the owner was
        evicted (pop + release run atomically under this same lock, so a
        True return means the owner's buffers were live at this instant
        and are now token-protected). Callers treating a cached buffer
        as valid MUST check this result; a bare memo read after a False
        touch is the r6 sf1.0 use-after-free (VERDICT r3 #1b)."""
        key = id(owner)
        with self._cond:
            e = self._entries.get(key)
            if e is None:
                return False
            self._seq += 1
            e.seq = self._seq
            e.users.update(self._tokens())
            return True

    def _forget(self, key) -> None:
        with self._cond:
            self._entries.pop(key, None)

    # -- accounting -------------------------------------------------------

    def pinned_bytes(self) -> int:
        with self._cond:
            return sum(e.nbytes for e in self._entries.values())

    def _evict_locked(self, need: int, protect: set) -> int:
        """Evict idle LRU entries until ``need`` bytes are freed (or no
        idle entries remain). Returns bytes freed. Lock held."""
        freed = 0
        cand = sorted(
            ((k, e) for k, e in self._entries.items()
             if e.users.isdisjoint(protect)),
            key=lambda kv: kv[1].seq,
        )
        for key, e in cand:
            if freed >= need:
                break
            self._entries.pop(key, None)
            owner = e.ref()
            if owner is not None:
                try:
                    e.release(owner)
                except Exception:  # noqa: BLE001 - eviction must not fail
                    pass
            freed += e.nbytes
            self.stats["evictions"] += 1
            self.stats["evicted_bytes"] += e.nbytes
        if freed:
            _drop_fused_struct_caches()
        return freed

    def evict_idle(self) -> int:
        """Evict every entry not in use by an in-flight query."""
        with self._cond:
            live = set(self._reservations)
            return self._evict_locked(1 << 62, live)

    def reserve(self, est: int, budget: int, block: bool = True):
        """Admit a query with an ``est``-byte working set under ``budget``.

        Evicts idle cache entries to fit; blocks (when ``block``) until
        concurrent reservations drain if still over; proceeds best-effort
        when running alone (the OOM ladder is the backstop). Returns a
        :class:`_Reservation`, or None when ``block=False`` and the query
        cannot fit next to the current in-flight set."""
        token = object()
        with self._cond:
            while True:
                live = set(self._reservations)
                pinned = sum(e.nbytes for e in self._entries.values())
                reserved = sum(self._reservations.values())
                over = pinned + reserved + est - budget
                if over > 0:
                    over -= self._evict_locked(over, live | {token})
                if over <= 0 or not self._reservations:
                    break  # fits, or alone: best-effort
                if not block:
                    return None
                self.stats["waits"] += 1
                self._cond.wait(timeout=60.0)
            self._reservations[token] = est
        return _Reservation(self, token)

    def release(self, token) -> None:
        with self._cond:
            self._reservations.pop(token, None)
            for e in self._entries.values():
                e.users.discard(token)
            self._cond.notify_all()


class _Reservation:
    """One admitted query's budget hold. As a context manager it also
    attributes the thread's charges to the query (the common, single-
    threaded ``execute()`` shape); ``execute_many`` instead holds the
    reservation across generator steps and wraps each step in
    ``ledger.activate(res.token)``."""

    def __init__(self, ledger: "DeviceLedger", token):
        self._ledger = ledger
        self.token = token
        self._closed = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._ledger.release(self.token)

    def __enter__(self):
        self._ledger._tokens().append(self.token)
        return self

    def __exit__(self, *exc):
        self._ledger._tokens().pop()
        self.close()


_LEDGER: Optional[DeviceLedger] = None


def device_ledger() -> DeviceLedger:
    global _LEDGER
    if _LEDGER is None:
        _LEDGER = DeviceLedger()
    return _LEDGER


def _release_column_caches(owner) -> None:
    """Ledger release callback for a host/paged column: delete every
    cached device buffer and clear the memos (``ineligible`` markers are
    host knowledge and survive)."""
    memo = getattr(owner, "_dev_memo", None)
    if memo:
        for k in [k for k in memo if k != "ineligible"]:
            dev = memo.pop(k)
            _delete_array(dev.data)
            _delete_array(dev.valid)
    csr = getattr(owner, "_csr_dev_memo", None)
    if csr is not None:
        if csr != (None,):
            # element 0 is the shared lru-cached _dev_scalar_i64: keep it
            for a in csr[1:]:
                _delete_array(a)
        object.__setattr__(owner, "_csr_dev_memo", None)


def clear_device_caches() -> None:
    """Drop every *idle* device-array cache (upload memos, CSR indexes,
    VARCHAR remaps, fused plan structures). Called on RESOURCE_EXHAUSTED;
    callers retry and repopulate lazily. Entries in use by other in-flight
    queries are left alone (deleting them mid-dispatch would turn their
    OOM into a use-after-free)."""
    import gc

    from .plan import fused as fz

    device_ledger().evict_idle()
    _drop_fused_struct_caches()
    fz.clear_remap_memo()
    gc.collect()


def _is_oom(err: BaseException) -> bool:
    s = str(err)
    return "RESOURCE_EXHAUSTED" in s or "Out of memory" in s


#: process-wide degradation tallies (VERDICT r4 #6: 'on-chip 113/113'
#: records could not be distinguished from host-fallback completions).
#: Read via :func:`engine_stats`; bench.py emits them in the metric
#: detail so every record shows how many queries degraded and why.
ENGINE_STATS: dict = {
    "oom_retries": 0,           # RESOURCE_EXHAUSTED -> cache-drop retry
    "oom_host_spills": 0,       # OOM retry ladder exhausted -> host
    "admission_host_spills": 0,  # inputs alone exceed HBM -> host
}
#: query names (plan._name) that degraded, per kind — same keys
ENGINE_STATS_QUERIES: dict = {k: [] for k in ENGINE_STATS}


def engine_stats() -> dict:
    out = dict(ENGINE_STATS)
    out["queries"] = {k: list(v) for k, v in ENGINE_STATS_QUERIES.items()
                      if v}
    return out


def reset_engine_stats() -> None:
    for k in ENGINE_STATS:
        ENGINE_STATS[k] = 0
        ENGINE_STATS_QUERIES[k].clear()


def _tally(kind: str, plan) -> None:
    ENGINE_STATS[kind] += 1
    name = getattr(plan, "_name", None)
    if name is not None:
        ENGINE_STATS_QUERIES[kind].append(str(name))


def _execute_fused(plan: Plan, context: Optional[Context]) -> HostTable:
    """Sort-free whole-plan fused execution (plan/fused.py): one XLA
    program per query over the shared per-column upload memo, exact
    totals + bounded root prefetch in one fetch, overflow retries with
    exact buckets."""
    import time

    from .plan import executor as _exec

    register_device_cache_plan(plan)

    gen = _fused_attempts(plan, context)
    stats = {"dispatch_ms": 0.0, "fetch_ms": 0.0, "rounds": 0}
    t0 = time.perf_counter()
    try:
        req = next(gen)
        while True:
            t1 = time.perf_counter()
            stats["dispatch_ms"] += (t1 - t0) * 1e3
            fetched = _exec.fetch_bundle(req)
            t0 = time.perf_counter()
            stats["fetch_ms"] += (t0 - t1) * 1e3
            stats["rounds"] += 1
            req = gen.send(fetched)
    except StopIteration as stop:
        stats["decode_ms"] = (time.perf_counter() - t0) * 1e3
        # per-query stage breakdown, readable by harnesses after execute()
        plan._last_exec_stats = stats
        if context is not None:
            context.last_exec_stats = stats
        return stop.value


def precompile_fused(plan: Plan, context: Optional[Context] = None) -> bool:
    """Compile — without executing — the plan's fused program at its
    initial bucket state (VERDICT r2 #6, cold start).

    Compilation is embarrassingly parallel, while the execute-based
    warmup serializes under device-memory admission control and pays real
    kernel time. Warmups call this from a thread pool: it resolves the
    column uploads (memoized — needed later anyway), then lowers and
    compiles against ShapeDtypeStruct avals only, populating the
    persistent compilation cache so the subsequent execute warmup's
    compiles become disk hits. Returns False for plans the fused engine
    cannot take (VARCHAR keys)."""
    import os

    from .plan import fused as fz

    register_device_cache_plan(plan)
    buckets: dict = {}
    unique_joins = _detect_unique_joins(plan)
    feedback_on = os.environ.get("RJT_CARD_FEEDBACK", "on") != "off"
    if feedback_on and not hasattr(plan, "_learned_buckets"):
        _feedback_store().load_into(plan)
    learned = getattr(plan, "_learned_buckets", None) if feedback_on else None
    if learned:
        for i, (pad, was_compacted) in learned.items():
            if was_compacted:
                buckets.setdefault(i, pad)
    budget = _hbm_budget()
    est = min(_estimate_scan_bytes(plan), budget)
    with device_ledger().reserve(est, budget):
        structure = fz.FusedPlan(
            plan, buckets, unique_joins, learned, frozenset()
        )
    if structure.has_varchar_key:
        return False
    state_key = (
        tuple(sorted(buckets.items())),
        tuple(sorted(learned.items())) if learned else None,
        frozenset(),
    )
    plan._fused_struct_cache = (state_key, structure)
    # compile AND retain the executable (fz._compiled_exec memo): the
    # subsequent execute path calls the same AOT object — no re-trace,
    # no re-lower, no executable re-load (r3's precompile compiled to a
    # thrown-away object and warmup paid the whole bill again)
    fz.compiled_plan(structure)
    return True


def _fused_attempts(plan: Plan, context: Optional[Context]):
    """Generator form of the fused executor: yields lists of device
    arrays whose fetched numpy values are sent back in, and returns the
    decoded HostTable (or None when the plan cannot fuse). Separating
    dispatch from fetch lets :func:`execute_many` overlap the device work
    and host transfers of many queries, which serial per-query execution
    cannot."""
    import os

    from .plan import executor as _exec
    from .plan import fused as fz

    buckets: dict = {}
    root_node = plan.nodes[plan.root]
    unique_joins = _detect_unique_joins(plan)
    prefetch_budget = int(os.environ.get("RJT_PREFETCH_BYTES", str(256 << 10)))
    full_budget = int(
        os.environ.get("RJT_PREFETCH_FULL_BYTES", str(256 << 10))
    )
    feedback_on = os.environ.get("RJT_CARD_FEEDBACK", "on") != "off"
    if feedback_on and not hasattr(plan, "_learned_buckets"):
        _feedback_store().load_into(plan)  # cross-process persistence
    learned = getattr(plan, "_learned_buckets", None) if feedback_on else None
    if learned:
        for i, (pad, was_compacted) in learned.items():
            if was_compacted:
                buckets.setdefault(i, pad)
    learned_root = (
        getattr(plan, "_learned_root_rows", None) if feedback_on else None
    )
    no_compact: set = set()
    for _attempt in range(len(plan.nodes) + 2):
        state_key = (
            tuple(sorted(buckets.items())),
            tuple(sorted(learned.items())) if learned else None,
            frozenset(no_compact),
        )
        cached = getattr(plan, "_fused_struct_cache", None)
        if (
            cached is not None
            and cached[0] == state_key
            and cached[1].revalidate()
        ):
            structure = cached[1]
        else:
            structure = fz.FusedPlan(
                plan, buckets, unique_joins, learned, frozenset(no_compact)
            )
            plan._fused_struct_cache = (state_key, structure)
        if structure.has_varchar_key:
            return None  # caller falls back to the stepwise engine
        # Hybrid dispatch: the first execution of a structure calls the
        # AOT executable (guaranteed no re-compile — precompile_fused
        # warmed exactly this object), but the AOT Python call path costs
        # milliseconds per query in aval processing. Later executions go
        # through the jitted wrapper: its first call re-traces (the XLA
        # compile is a persistent-cache hit) and then dispatches on the
        # C++ fast path.
        if getattr(structure, "_dispatched", False):
            fn = fz.compile_plan(structure)
        else:
            fn = fz.compiled_plan(structure)
            structure._dispatched = True
        out_values_dev, out_valid_dev, totals_dev = fn(
            tuple(structure.col_args), tuple(structure.aux_args)
        )

        # bounded root prefetch rides the totals fetch (same policy as
        # the wave executor, see plan/executor.py run_plan)
        root_arrays = tuple(out_values_dev) + tuple(out_valid_dev)
        row_bytes = max(1, sum(a.dtype.itemsize for a in root_arrays))
        root_pad = structure.root_pad
        if root_pad * row_bytes <= full_budget:
            k_pad = root_pad
        else:
            k_pad = join_ops.bucket_size(1)
            while (
                k_pad * 2 <= root_pad
                and k_pad * 2 * row_bytes <= prefetch_budget
            ):
                k_pad *= 2
            if learned_root is not None:
                # feedback: we know the root row count from the previous
                # execution — widen the prefetch window to cover it so a
                # repeat run never pays a second fetch burst (transfer
                # rides the same round trip; a stale undersized value
                # still falls through to the exact second fetch below)
                k_pad = min(
                    root_pad,
                    max(k_pad, join_ops.bucket_size(max(1, learned_root))),
                )
            if k_pad < root_pad:
                root_arrays = _exec._slice_cols(root_arrays, k_pad)
        fetched = yield [totals_dev] + list(root_arrays)
        totals, pre = fetched[0], fetched[1:]

        # exactness: a join's total is trustworthy iff no descendant
        # general join overflowed its bucket; probe-shaped strategies
        # cannot overflow
        join_order = structure.join_order
        exact: dict = {}
        overflow = False
        for ji, node_id in enumerate(join_order):
            spec = structure.join_specs[node_id]
            probe_shaped = spec.strategy in (
                "unique_scatter", "unique_sort", "empty"
            )
            deps_ok = all(
                exact.get(d, True) for d in (spec.left, spec.right)
            )
            fits = probe_shaped or int(totals[ji]) <= spec.out_pad
            if (
                spec.compact_pad
                and int(totals[ji]) > spec.compact_pad
            ):
                # stale learned pad truncated this probe-shaped output
                no_compact.add(node_id)
                fits = False
                overflow = True
            exact[node_id] = deps_ok and fits
            if probe_shaped:
                continue
            if deps_ok and not fits:
                buckets[node_id] = join_ops.bucket_size(int(totals[ji]))
                overflow = True
            elif not deps_ok:
                buckets[node_id] = max(
                    buckets.get(node_id, spec.out_pad) * 2, spec.out_pad * 2
                )
                overflow = True
            else:
                buckets[node_id] = join_ops.bucket_size(int(totals[ji]))
        if overflow:
            continue

        if isinstance(root_node.data, ScanNode):
            root_total = plan.inputs[root_node.data.base_table_id].num_rows
        else:
            root_total = int(totals[join_order.index(plan.root)])

        fz.count_paths(structure)
        # per-join exact output cardinalities of this execution — the
        # per-query WORK signal (final result rows alone under-weight
        # queries whose cost is intermediate fan-out)
        plan._last_join_totals = {
            node_id: int(totals[ji])
            for ji, node_id in enumerate(join_order)
        }
        if feedback_on:
            plan._learned_root_rows = root_total
            plan._learned_buckets = {
                node_id: (
                    join_ops.bucket_size(int(totals[ji])),
                    structure.join_specs[node_id].strategy
                    not in ("unique_scatter", "unique_sort"),
                )
                for ji, node_id in enumerate(join_order)
            }
            _feedback_store().put(plan)

        k = len(out_values_dev)
        if root_total <= k_pad:
            out_values, out_valid = list(pre[:k]), list(pre[k:])
        else:
            fetch_pad = min(join_ops.bucket_size(root_total), root_pad)
            sliced = _exec._slice_cols(
                tuple(out_values_dev) + tuple(out_valid_dev), fetch_pad
            )
            fetched2 = yield list(sliced)
            out_values, out_valid = fetched2[:k], fetched2[k:]

        sources = structure.col_sources[plan.root]
        cols: List[HostColumn] = []
        for ko, (ci, dt) in enumerate(root_node.output_attrs):
            values = out_values[ko][:root_total]
            valid = out_valid[ko][:root_total]
            if dt is DataType.VARCHAR:
                d = structure.dicts[sources[ko]] or StringDict.empty()
                if root_total == 0 or d.size == 0:
                    cols.append(
                        HostColumn.varchar(
                            np.zeros(0, np.uint8),
                            np.zeros(root_total, np.int64),
                            valid,
                        )
                    )
                else:
                    ids = np.clip(values, 0, d.size - 1)
                    starts = np.where(valid, d.starts[ids], 0)
                    lengths = np.where(valid, d.lengths[ids], 0)
                    heap, ends = gather_varlen(d.heap, starts, lengths)
                    cols.append(HostColumn.varchar(heap, ends, valid))
            elif dt is DataType.FP64:
                cols.append(HostColumn(dt, values.view(np.float64), valid))
            else:
                cols.append(HostColumn(dt, values, valid))
        return HostTable(root_total, cols)
    raise RuntimeError("fused plan did not converge to exact buckets")


# ---------------------------------------------------------------------------
# Host-staged multi-pass radix execution (inputs exceed device HBM budget)
# ---------------------------------------------------------------------------


def _host_normalize_keys(b: HostColumn, p: HostColumn):
    """Comparable (key, valid) numpy pairs, or None on a type mismatch
    (same semantics as :func:`normalize_join_keys`, host side)."""
    if b.dtype is not p.dtype:
        return None
    if b.dtype is DataType.VARCHAR:
        bo = np.where(b.valid, b.objects(), b"")
        po = np.where(p.valid, p.objects(), b"")
        rb_, rp_, _ = keynorm.joint_id_inverse(bo, po)
        return (
            (rb_.astype(np.int64), b.valid),
            (rp_.astype(np.int64), p.valid),
        )
    if b.dtype is DataType.FP64:
        def canon(col):
            return keynorm.canon_f64_bits(
                col.values.view(np.int64), col.valid
            )
        return canon(b), canon(p)
    return (b.values, b.valid), (p.values, p.valid)


def _empty_host_table(output_attrs) -> HostTable:
    cols = []
    for _, dt in output_attrs:
        if dt is DataType.VARCHAR:
            cols.append(HostColumn.varchar(
                np.zeros(0, np.uint8), np.zeros(0, np.int64), np.zeros(0, bool)
            ))
        else:
            cols.append(HostColumn(
                dt, np.zeros(0, dt.numpy_dtype), np.zeros(0, bool)
            ))
    return HostTable(0, cols)


def _execute_host_partitioned(
    plan: Plan, budget_bytes: Optional[int] = None
) -> HostTable:
    """Out-of-HBM executor: tables stay host-resident; every join streams
    hash partitions through the device pair by pair (ops/radix.py), and
    materialization is a host-side ``take`` at the surviving row pairs.

    This is the multi-pass generalization of the reference's single L2
    radix pass (src/execute.cpp:86-92) to the host-RAM/HBM tier split.
    """
    from .ops import radix

    results: dict = {}
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            host = plan.inputs[node.data.base_table_id].to_host()
            cols = []
            for ci, dt in node.output_attrs:
                col = host.columns[ci]
                if col.dtype is not dt:
                    raise TypeError(
                        f"scan output attr {ci}: declared {dt}, stored {col.dtype}"
                    )
                cols.append(col)
            results[idx] = HostTable(host.num_rows, cols)
            continue

        j = node.data
        left, right = results[j.left], results[j.right]
        if left.num_rows == 0 or right.num_rows == 0:
            results[idx] = _empty_host_table(node.output_attrs)
            continue
        if j.build_left:
            build, probe = left, right
            battr, pattr = j.left_attr, j.right_attr
        else:
            build, probe = right, left
            battr, pattr = j.right_attr, j.left_attr
        keys = _host_normalize_keys(build.columns[battr], probe.columns[pattr])
        if keys is None:
            results[idx] = _empty_host_table(node.output_attrs)
            continue
        (kb, vb), (kp, vp) = keys
        bidx, pidx = radix.partitioned_join_indices(
            kb, vb, kp, vp, budget_bytes=budget_bytes
        )
        lidx = bidx if j.build_left else pidx
        ridx = pidx if j.build_left else bidx
        left_w = len(left.columns)
        cols = []
        for ci, dt in node.output_attrs:
            src, sel = (left.columns[ci], lidx) if ci < left_w else (
                right.columns[ci - left_w], ridx
            )
            cols.append(src.take(sel))
        results[idx] = HostTable(len(lidx), cols)
    return results[plan.root]


def _esize(dt) -> int:
    return 4 if dt in (DataType.INT32, DataType.VARCHAR) else 8


def _estimate_scan_bytes(plan: Plan) -> int:
    """Padded device footprint of all scan inputs (pow2 pad, values+valid),
    deduplicated: a (table, column) shared by several scan nodes uploads
    once through the memo."""
    seen = set()
    total = 0
    for node in plan.nodes:
        if not isinstance(node.data, ScanNode):
            continue
        table = plan.inputs[node.data.base_table_id]
        pad = join_ops.bucket_size(table.num_rows)
        for ci, dt in node.output_attrs:
            key = (node.data.base_table_id, ci)
            if key in seen:
                continue
            seen.add(key)
            total += pad * (_esize(dt) + 1)
    return total


def _estimate_query_bytes(plan: Plan) -> int:
    """Working-set estimate of one query's device execution (VERDICT r2
    #1: round 2 counted scan inputs only, so sf1.0 plans "fit", never
    spilled, then OOM'd mid-pass).

    XLA frees a fused program's intermediates as their liveness ends, so
    the peak is scan inputs (live for the whole program) plus the largest
    join's output buffers and sort/expansion transients — NOT the sum of
    every join output. Learned cardinality-feedback buckets shrink the
    estimate on repeat executions exactly like they shrink the real
    footprint."""
    feedback = getattr(plan, "_learned_buckets", None) or {}
    pads: dict = {}
    max_out = 0
    max_transient = 0
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            pads[idx] = join_ops.bucket_size(
                plan.inputs[node.data.base_table_id].num_rows
            )
            continue
        j = node.data
        bpad = pads[j.left if j.build_left else j.right]
        ppad = pads[j.right if j.build_left else j.left]
        learned = feedback.get(idx)
        out_pad = learned[0] if learned else ppad
        pads[idx] = out_pad
        # output columns + expansion scratch (bidx/pidx/live/marker ~13B)
        row_bytes = sum(_esize(dt) + 1 for _, dt in node.output_attrs) + 13
        max_out = max(max_out, out_pad * row_bytes)
        # merge-join co-sort of (build ++ probe) packed i64, in + out
        max_transient = max(max_transient, (bpad + ppad) * 16)
    return _estimate_scan_bytes(plan) + max_out + max_out // 2 + max_transient


def _hbm_budget() -> int:
    """Device-resident working-set budget in bytes (the spill-path
    threshold): RJT_HBM_BUDGET_BYTES, or half the memory the runtime lets
    this process allocate on the device. Shared by execute() and
    execute_many() so a plan spills identically in both."""
    import os

    env_budget = os.environ.get("RJT_HBM_BUDGET_BYTES")
    if env_budget:
        return int(env_budget)
    from . import hardware

    return hardware.device_memory_bytes() // 2


def execute(plan: Plan, context: Optional[Context] = None) -> ColumnarTable:
    """Evaluate ``plan`` and encode the result as a paged ColumnarTable.

    Equivalent to the reference ``Contest::execute`` (src/execute.cpp:316-324).
    Uses the fused whole-plan program when the working set fits the device
    HBM budget; spills to the host-staged multi-pass radix executor when it
    does not. The shape-shared wave executor is the fallback for the rare
    plan the fused compiler declines (e.g. a VARCHAR key column with no
    dictionary).
    """
    import os

    plan.validate()
    budget = _hbm_budget()
    mode = os.environ.get("RJT_EXEC_MODE", "auto")

    def _run_on_device():
        host = None
        if mode in ("auto", "fused"):
            # default: one sort-free XLA program per query (plan/fused.py)
            host = _execute_fused(plan, context)
            if host is None:
                # VARCHAR join keys can't fuse: the shape-shared executor
                # is the fast fallback (it handles dictionary unification)
                from .plan import executor

                host = executor.execute_shared(
                    plan, _detect_unique_joins(plan)
                )
        elif mode == "stepwise":
            host = device_table_to_host(execute_device(plan, context))
        else:
            # RJT_EXEC_MODE=shared: shape-shared per-operator kernels
            # reused across queries — lowest cold-start compile bill (a
            # handful of shared programs instead of one per query)
            from .plan import executor

            host = executor.execute_shared(plan, _detect_unique_joins(plan))
        if host is None:
            dev = execute_device(plan, context)
            host = device_table_to_host(dev)
        return host

    if _estimate_scan_bytes(plan) > budget:
        # the inputs alone exceed device HBM: host-staged multi-pass radix
        _tally("admission_host_spills", plan)
        device_ledger().evict_idle()
        _settle_deallocs()
        host = _execute_host_partitioned(plan, budget_bytes=budget // 8)
    else:
        est = min(_estimate_query_bytes(plan), budget)
        with device_ledger().reserve(est, budget):
            try:
                host = _run_on_device()
            except Exception as err:  # noqa: BLE001 - filtered to OOM below
                if not _is_oom(err):
                    raise
                # estimate was short (e.g. first run of a fan-out-heavy
                # plan): drop every idle device cache and retry cold; if
                # the query alone still cannot fit, stream it through the
                # host-staged multi-pass radix executor
                _tally("oom_retries", plan)
                clear_device_caches()
                _settle_deallocs()
                try:
                    host = _run_on_device()
                except Exception as err2:  # noqa: BLE001
                    if not _is_oom(err2):
                        raise
                    clear_device_caches()
                    _settle_deallocs()
                    try:
                        host = _run_on_device()
                    except Exception as err3:  # noqa: BLE001
                        if not _is_oom(err3):
                            raise
                        _tally("oom_host_spills", plan)
                        clear_device_caches()
                        _settle_deallocs()
                        host = _execute_host_partitioned(
                            plan, budget_bytes=budget // 8
                        )
    return _encode_result(host)


def _settle_deallocs() -> None:
    """One device round trip after dropping caches: it orders the
    runtime's queue behind the freed buffers before a retry."""
    jax.device_get(jnp.zeros(8, jnp.int32) + 1)


def _encode_result(host: HostTable) -> ColumnarTable:
    """HostTable -> paged ColumnarTable (the reference's final
    to_columnar step, src/execute.cpp:322-323)."""
    cols = []
    for c in host.columns:
        if c.dtype is DataType.VARCHAR:
            pages = page_codec.encode_varchar_heap(c.heap, c.ends, c.valid)
        else:
            pages = page_codec.encode_fixed(c.values, c.valid, c.dtype)
        cols.append(Column(c.dtype, pages))
    return ColumnarTable(host.num_rows, cols)


def execute_many(
    plans: List[Plan], context: Optional[Context] = None
) -> List[ColumnarTable]:
    """Throughput mode: evaluate a batch of plans with overlapped
    dispatch and host transfers.

    ``execute`` is latency-shaped (the reference's per-query contract,
    src/execute.cpp:316-324): each call dispatches, then blocks on its
    own result fetch, which nothing else can hide. This batch form
    runs the same fused programs but phases the work across queries:
    every plan's XLA program is dispatched first (async), then every
    plan's packed result buffer starts its device->host copy
    (``copy_to_host_async``), and only then are the buffers consumed in
    order — so device compute and all transfers overlap instead of
    serializing. Plans the fused compiler declines (or that exceed the
    HBM budget) fall back to :func:`execute` inline. Results are
    identical to per-plan ``execute`` calls, in input order.
    """
    import os

    from .plan import executor as _exec

    results: List[Optional[ColumnarTable]] = [None] * len(plans)
    live: dict = {}  # idx -> (generator, (buf_dev, spec))
    tokens: dict = {}  # idx -> ledger reservation context
    ledger = device_ledger()

    def _release(idx: int) -> None:
        res = tokens.pop(idx, None)
        if res is not None:
            res.close()

    def start(idx: int, gen):
        """Advance a fresh generator to its first fetch request (packing
        the requested arrays) or finish it immediately."""
        try:
            with ledger.activate(tokens[idx].token):
                req = next(gen)
        except StopIteration as stop:
            _finish(idx, stop.value)
            return
        except Exception as err:  # noqa: BLE001 - OOM only
            if not _is_oom(err):
                raise
            _release(idx)
            clear_device_caches()
            fallbacks.append(idx)  # retried via execute()'s OOM ladder
            return
        live[idx] = (gen, _exec.pack_bundle(req))

    fallbacks: List[int] = []

    def _finish(idx: int, host):
        live.pop(idx, None)
        _release(idx)
        if host is None:  # fused compiler declined: single-plan fallback
            fallbacks.append(idx)
        else:
            results[idx] = _encode_result(host)

    if os.environ.get("RJT_EXEC_MODE", "auto") not in ("auto", "fused"):
        return [execute(p, context) for p in plans]

    budget = _hbm_budget()

    def _try_start(idx: int) -> bool:
        """Admit + dispatch one plan; False = does not fit next to the
        in-flight set right now (caller retries after a drain round)."""
        plan = plans[idx]
        est = min(_estimate_query_bytes(plan), budget)
        res = ledger.reserve(est, budget, block=False)
        if res is None:
            return False
        tokens[idx] = res
        start(idx, _fused_attempts(plan, context))
        return True

    # Admission-aware start order (VERDICT r4 weak #6: at sf1.0 the
    # batch LOST to serial because the input-order walk admitted one
    # over-budget query at a time and nothing overlapped): start the
    # cheapest queries first — many small reservations co-admit and
    # overlap their fetches — and let the over-budget giants serialize
    # through admission at the END, where they no longer block the
    # small ones' concurrency.
    deferred: List[int] = []
    order_sm = sorted(
        range(len(plans)),
        key=lambda i: min(_estimate_query_bytes(plans[i]), budget),
    )
    for idx in order_sm:
        plan = plans[idx]
        plan.validate()
        if _estimate_scan_bytes(plan) > budget:
            fallbacks.append(idx)  # spill path, host-staged
            continue
        if not _try_start(idx):
            deferred.append(idx)  # admission-controlled: start post-drain

    # Serial fallbacks (fused-declined / over-budget plans) run AFTER the
    # dispatch loop, while the dispatched fused programs compute on the
    # device — inline they would stall dispatch of every later plan.
    for idx in fallbacks:
        results[idx] = execute(plans[idx], context)
    fallbacks.clear()

    while live or deferred:
        if not live:
            # admission: with nothing in flight the reserve always admits
            _try_start(deferred.pop(0))
            continue
        # hint the runtime to begin every pending device->host copy
        for gen, (buf, spec) in live.values():
            if buf is not None and hasattr(buf, "copy_to_host_async"):
                buf.copy_to_host_async()
        # materialize all pending buffers concurrently (each device_get
        # is its own transfer)
        order = sorted(live)
        bufs = [live[i][1][0] for i in order]
        if len(bufs) > 1:
            import concurrent.futures as cf

            # cap fetch concurrency: large result buffers contend on the
            # host link
            fetch_par = int(os.environ.get("RJT_FETCH_PAR", "4"))
            with cf.ThreadPoolExecutor(
                min(max(fetch_par, 1), len(bufs))
            ) as pool:
                host_bufs = list(pool.map(
                    lambda b: None if b is None else np.asarray(b), bufs
                ))
        else:
            host_bufs = [None if b is None else np.asarray(b) for b in bufs]
        fetched_np = dict(zip(order, host_bufs))
        # consume in index order; overflow retries re-enter `live` and
        # are drained on the next round (rare: cold runs only)
        for idx in order:
            gen, (buf, spec) = live.pop(idx)
            hb = fetched_np[idx]
            fetched = [] if hb is None else _exec.unpack_bundle(hb, spec)
            try:
                with ledger.activate(tokens[idx].token):
                    req = gen.send(fetched)
            except StopIteration as stop:
                _finish(idx, stop.value)
                continue
            except Exception as err:  # noqa: BLE001 - OOM only
                if not _is_oom(err):
                    raise
                _release(idx)
                clear_device_caches()
                fallbacks.append(idx)
                continue
            live[idx] = (gen, _exec.pack_bundle(req))
        # freed reservations admit deferred plans for the next round
        still = []
        for idx in deferred:
            if not _try_start(idx):
                still.append(idx)
        deferred = still
    for idx in fallbacks:  # a generator declined after dispatch (rare)
        results[idx] = execute(plans[idx], context)
    return results
