"""Sort-free whole-plan compiler: ONE XLA program per query.

The reference *interprets* the join tree node by node over row vectors
(src/execute.cpp:302-314); the shape-shared wave executor
(plan/executor.py) replaces that with ~dozens of small shared programs
per query, each a dispatch and each sync a round trip. Fused into one
program, a query costs one dispatch and ONE result fetch.

Differences from the first-generation fused compiler (git history,
plan/compiler.py, removed):

* **No packed uint8 buffer.** Inputs are per-column device arrays shared
  with the wave executor's upload memo (`_device_column_cached`) — a base
  table is uploaded once per process no matter which engine mode runs,
  and switching modes does not re-upload.
* **Sort-free join lowering.** Joins lower exactly like the executor's
  fast paths: dense-window scatter tables for FK->PK
  (ops/join.py join_unique_scatter_impl), host-CSR grouped scans for
  general joins — on either side, with role swap (join_csr_impl).
  Both-children-intermediate joins use a **device-built CSR** over the
  key's origin-base-column window (join_dev_csr_impl: histogram
  scatter + cumsum + one small build-side-only sort) when the window
  is economic, and fall back to the single-sort merge join otherwise.
* **Bounded root prefetch**: the totals and the first
  ``RJT_PREFETCH_BYTES`` worth of root rows ride one fetch; only results
  that overflow that window pay a second round trip.

Join output cardinalities are data-dependent, which XLA cannot express,
so every general join writes into a **static pow2 bucket** seeded by the
probe child's pad; the program emits exact per-join totals, the host
checks ``total <= bucket`` after the fetch, and overflows (rare) re-run
with exact buckets — results are always exact, never silently truncated.

VARCHAR join *keys* fuse too: the two origin dictionaries (reachable
through ``col_sources`` provenance) are unified on the host once per
column pair, the id remaps ride in as operands, and the join lowers as
a device-CSR over the unified id space (JOB never joins on strings,
reference ANNOUNCEMENTS.md:11, but generic workloads do). VARCHAR
payload columns flow through as dictionary ids.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import DataType
from ..ops import join as join_ops
from ..ops import keynorm
from .ir import JoinNode, Plan, ScanNode
from . import executor as _ex


@dataclasses.dataclass(frozen=True)
class _ScanSpec:
    pad: int
    cols: Tuple[int, ...]  # per output attr -> index into the arg column list


@dataclasses.dataclass(frozen=True)
class _JoinSpec:
    build_left: bool
    left: int
    right: int
    left_attr: int
    right_attr: int
    key_dtype: Optional[DataType]  # None => statically empty (type mismatch)
    out_pad: int
    # output attr -> (side 0=left/1=right, column index in that child)
    out_cols: Tuple[Tuple[int, int], ...]
    #: "empty" | "unique_scatter" | "unique_sort" | "csr" | "csr_swapped"
    #: | "dev_csr" | "dev_csr_swapped" | "merge"
    strategy: str
    r_pad: int = 0  # key window (unique_scatter / dev_csr*)
    aux_id: int = -1  # index into the aux arg list (scatter/csr operands)
    #: probe-shaped joins only: compact the output to this learned pad
    #: inside the program (cardinality feedback); 0 = no compaction. A
    #: stale undersized pad truncates — the engine detects
    #: ``total > compact_pad`` and retries without it.
    compact_pad: int = 0


def _big_merge(bpad: int, ppad: int) -> bool:
    """Route general joins with huge padded sides to the merge path
    (see the inline note at the call site). ``RJT_BIG_MERGE`` = minimum
    combined pad (build+probe) for the reroute; 0 disables."""
    thr = int(os.environ.get("RJT_BIG_MERGE", str(1 << 23)))
    return thr > 0 and (bpad + ppad) >= thr


class FusedPlan:
    """Static structure + device operands of one fused query program.

    ``learned`` (cardinality feedback, shared with the wave executor via
    ``plan._learned_buckets``): general joins seed exact buckets through
    ``buckets``; probe-shaped joins get an in-program compaction to
    their learned pad (``_JoinSpec.compact_pad``) so downstream stages
    run at live-row scale inside the single program."""

    def __init__(self, plan: Plan, buckets: Dict[int, int],
                 unique_joins: frozenset,
                 learned: Optional[Dict[int, Tuple[int, bool]]] = None,
                 no_compact: frozenset = frozenset()):
        from .. import engine as eng

        self.plan = plan
        self.order = plan.topo_order()
        self.buckets = dict(buckets)
        self.scan_specs: Dict[int, _ScanSpec] = {}
        self.join_specs: Dict[int, _JoinSpec] = {}
        self.has_varchar_key = False
        #: flat device column operands [(data, valid), ...]
        self.col_args: List[Tuple] = []
        #: per-join aux operands: scatter -> (base,), csr -> (base, c, s, g)
        self.aux_args: List[Tuple] = []
        #: ledger owners (host/paged columns) whose memos back col_args /
        #: aux_args — re-touched on every struct-cache hit (revalidate)
        self.source_owners: List = []
        #: packed col id -> StringDict or None (dictionary provenance)
        self.dicts: List = []
        # node -> per-output-attr packed col id (for root dict lookup)
        self.col_sources: Dict[int, Tuple[int, ...]] = {}

        pads: Dict[int, int] = {}
        packed: Dict[Tuple[int, int, int], int] = {}

        for idx in self.order:
            node = plan.nodes[idx]
            if isinstance(node.data, ScanNode):
                table = plan.inputs[node.data.base_table_id]
                pad = join_ops.bucket_size(table.num_rows)
                pads[idx] = pad
                col_ids = []
                host = None
                for col_idx, dt in node.output_attrs:
                    key = (node.data.base_table_id, col_idx, pad)
                    if key not in packed:
                        # raw-page upload + on-chip decode where aligned;
                        # host decode + dense upload otherwise
                        owner = table.columns[col_idx]
                        dev = _ex._paged_column_cached(
                            eng, owner, table.num_rows, pad
                        )
                        if dev is None:
                            if host is None:
                                host = table.to_host()
                            owner = host.columns[col_idx]
                            dev = _ex._device_column_cached(
                                eng, owner, pad
                            )
                        packed[key] = len(self.col_args)
                        self.col_args.append((dev.data, dev.valid))
                        self.dicts.append(dev.dictionary)
                        self.source_owners.append(owner)
                    col_ids.append(packed[key])
                self.scan_specs[idx] = _ScanSpec(pad, tuple(col_ids))
                self.col_sources[idx] = tuple(col_ids)
                continue

            j = node.data
            left_w = len(plan.nodes[j.left].output_attrs)
            lt = plan.nodes[j.left].output_attrs[j.left_attr][1]
            rt = plan.nodes[j.right].output_attrs[j.right_attr][1]
            key_dtype = lt if lt is rt else None
            battr = j.left_attr if j.build_left else j.right_attr
            pattr = j.right_attr if j.build_left else j.left_attr
            bchild = j.left if j.build_left else j.right
            pchild = j.right if j.build_left else j.left

            strategy, r_pad, aux_id = "merge", 0, -1
            if key_dtype is None:
                strategy = "empty"
            elif key_dtype is DataType.VARCHAR:
                # dictionary ids flow through gathers unchanged, so the
                # origin dictionaries (via col_sources provenance) are
                # unified on the host — once per column pair — and the
                # join runs as a device-CSR over unified ids (JOB never
                # joins on strings, reference ANNOUNCEMENTS.md:11, but
                # generic workloads do)
                hv = self._varchar_dev_csr(
                    bchild, battr, pchild, pattr,
                    pads[bchild], pads[pchild],
                )
                if hv is None:
                    self.has_varchar_key = True
                    return  # caller falls back to the stepwise engine
                swapped, aux, r_pad = hv
                strategy = "dev_csr_swapped" if swapped else "dev_csr"
                aux_id = len(self.aux_args)
                self.aux_args.append(aux)
            elif (
                idx in unique_joins
                and key_dtype in (DataType.INT32, DataType.INT64)
                and self.buckets.get(idx) is None
            ):
                window = _ex._unique_scatter_window(
                    plan, j, battr, pads[bchild], pads[pchild]
                )
                if window is not None:
                    strategy = "unique_scatter"
                    base, r_pad = window
                    aux_id = len(self.aux_args)
                    self.aux_args.append((_ex._dev_scalar_i64(base),))
                else:
                    strategy = "unique_sort"
            elif _big_merge(pads[bchild], pads[pchild]):
                # huge padded sides take the sort-carried merge path
                # (RJT_BIG_MERGE); strategy stays "merge"
                pass
            else:
                csr = _ex._general_csr_index(
                    plan, j, battr, pattr, pads[bchild], pads[pchild]
                )
                if csr is not None:
                    (base, counts_w, starts_w, grouped), swapped, owner = csr
                    strategy = "csr_swapped" if swapped else "csr"
                    aux_id = len(self.aux_args)
                    self.aux_args.append((base, counts_w, starts_w, grouped))
                    self.source_owners.append(owner)
                elif key_dtype in (DataType.INT32, DataType.INT64):
                    # both children intermediate: device-built CSR over
                    # the key's origin base-column window (one build-side
                    # sort instead of the merge join's build++probe
                    # co-sort). Prefer indexing the smaller side.
                    dev_csr = _ex._dev_csr_window(
                        plan, j, battr, pattr,
                        pads[bchild], pads[pchild],
                    )
                    if dev_csr is not None:
                        swapped, base, r_pad = dev_csr
                        strategy = (
                            "dev_csr_swapped" if swapped else "dev_csr"
                        )
                        aux_id = len(self.aux_args)
                        self.aux_args.append((_ex._dev_scalar_i64(base),))

            compact_pad = 0
            if strategy in ("unique_scatter", "unique_sort"):
                out_pad = pads[pchild]  # probe-shaped, cannot overflow
                if learned and idx != plan.root and idx not in no_compact:
                    lp, was_compacted = learned.get(idx, (None, None))
                    if (
                        lp is not None and not was_compacted
                        and lp * 4 <= out_pad
                    ):
                        compact_pad = lp
                        pads[idx] = lp
            else:
                out_pad = self.buckets.get(idx) or pads[pchild]
            if compact_pad == 0:
                pads[idx] = out_pad
            out_cols = tuple(
                (0, ci) if ci < left_w else (1, ci - left_w)
                for ci, _ in node.output_attrs
            )
            self.join_specs[idx] = _JoinSpec(
                j.build_left, j.left, j.right, j.left_attr, j.right_attr,
                key_dtype, out_pad, out_cols, strategy, r_pad, aux_id,
                compact_pad,
            )
            self.col_sources[idx] = tuple(
                self.col_sources[j.left][ci]
                if ci < left_w
                else self.col_sources[j.right][ci - left_w]
                for ci, _ in node.output_attrs
            )

        self.join_order = [i for i in self.order if i in self.join_specs]
        self.root_pad = pads[plan.root]


    def revalidate(self) -> bool:
        """Struct-cache hits reuse device arrays resolved on a previous
        run. Re-touch their ledger owners under the caller's active
        reservation token — protecting them from concurrent eviction for
        the rest of this query — then verify nothing was already evicted
        (a concurrent ``reserve()`` may have deleted a cached buffer
        between this plan's runs: the concurrent-admission
        use-after-free, tests/test_ledger.py). False means rebuild; the
        rebuild re-resolves the column memos, re-uploading what was
        evicted.

        TOCTOU invariant: ``touch`` registers the
        caller's token ATOMICALLY with the liveness check (eviction pops
        the entry and deletes its buffers under the same ledger lock), so
        ``touch() == True`` means the buffers were live at that instant
        and cannot be evicted until the caller's reservation is released
        — which happens only after dispatch completes, because every
        ``_fused_attempts`` consumer runs inside
        ``device_ledger().reserve(...)`` for the whole query. A False
        touch (owner evicted, or re-charged by a concurrent thread whose
        upload replaced our arrays) forces the rebuild, whose memo reads
        re-pin under the same protocol (executor._device_column_cached)."""
        from .. import engine as _eng

        ledger = _eng.device_ledger()
        ok = True
        for o in self.source_owners:
            ok &= ledger.touch(o)
        if not ok:
            return False
        for d, v in self.col_args:
            if d.is_deleted() or v.is_deleted():
                return False
        for aux in self.aux_args:
            for a in aux:
                if hasattr(a, "is_deleted") and a.is_deleted():
                    return False
        return True

    def _varchar_dev_csr(self, bchild, battr, pchild, pattr, bpad, ppad):
        """VARCHAR join key lowering: ``(swapped, aux, r_pad)`` or None.

        ``aux`` = (base scalar 0, build-side remap, probe-side remap) —
        the remaps carry each side's dictionary ids onto the unified id
        space. The window is the unified dictionary size (dense by
        construction). The smaller-padded side is indexed."""
        da = self.dicts[self.col_sources[bchild][battr]]
        db = self.dicts[self.col_sources[pchild][pattr]]
        if da is None or db is None:
            return None
        remap_b, remap_p, size = _unified_remap(da, db)
        r_pad = join_ops.bucket_size(max(size, 1))
        if r_pad > (1 << 26):
            return None
        swapped = ppad < bpad
        return swapped, (_ex._dev_scalar_i64(0), remap_b, remap_p), r_pad

    def cache_key(self) -> tuple:
        # Structures are memoized per plan state (engine._execute_fused)
        # and immutable once built, so the key is computed once: the
        # astuple walk costs ~0.5 ms and would otherwise run per execute.
        key = getattr(self, "_cache_key", None)
        if key is not None:
            return key
        scans = tuple(
            (i, s.pad, s.cols) for i, s in self.scan_specs.items()
        )
        joins = tuple(
            (i,) + dataclasses.astuple(self.join_specs[i])
            for i in self.join_order
        )
        root = self.plan.root
        root_attrs = tuple(self.plan.nodes[root].output_attrs)
        self._cache_key = (scans, joins, root, root_attrs)
        return self._cache_key


# Unified-dictionary remap memo for VARCHAR join keys. Keyed by object
# identity of the two StringDicts — safe because dictionaries live for
# the process lifetime in the per-column upload memo, and pinned here
# regardless so ids can never be reused. Small (JOB never joins on
# strings, reference ANNOUNCEMENTS.md:11); dropped wholesale by
# :func:`clear_remap_memo` under memory pressure.
_REMAP_MEMO: Dict[Tuple[int, int], Tuple] = {}
_REMAP_PIN: List = []


def clear_remap_memo() -> None:
    # drop refs only (no explicit .delete(): an in-flight VARCHAR-key
    # query may still hold these in its FusedPlan aux_args) — GC frees
    # them once the struct caches are dropped too
    _REMAP_MEMO.clear()
    _REMAP_PIN.clear()


def _unified_remap(da, db):
    """Map two dictionaries onto one joint id space (exact, memoized).
    Returns (remap_a_dev, remap_b_dev, joint_size)."""
    key = (id(da), id(db))
    hit = _REMAP_MEMO.get(key)
    if hit is None:
        ra, rb, size = keynorm.joint_id_inverse(da.objects(), db.objects())
        hit = (jax.device_put(ra), jax.device_put(rb), size)
        _REMAP_MEMO[key] = hit
        _REMAP_PIN.extend((da, db))
    return hit


def _remap_ids(ids, mapping):
    """Dictionary ids -> unified ids (invalid rows carry arbitrary ids;
    they are clamped here and masked by validity in the kernels)."""
    if mapping.shape[0] == 0:
        return jnp.zeros_like(ids)
    return mapping[jnp.clip(ids, 0, mapping.shape[0] - 1)]


def _normalize_key(data, valid, dt: DataType):
    # FP64 keys arrive bitcast to i64 at upload; canonicalize -0.0 and NaN
    if dt is DataType.FP64:
        data, valid = keynorm.canon_f64_bits(data, valid)
    return data, valid


def _trace(structure: FusedPlan, col_args, aux_args):
    plan = structure.plan
    tables: Dict[int, List[Tuple[jnp.ndarray, jnp.ndarray]]] = {}
    totals = []

    for idx in structure.order:
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            spec = structure.scan_specs[idx]
            tables[idx] = [col_args[c] for c in spec.cols]
            continue

        spec = structure.join_specs[idx]
        left, right = tables[spec.left], tables[spec.right]
        if spec.build_left:
            (kb, vb), (kp, vp) = left[spec.left_attr], right[spec.right_attr]
        else:
            (kb, vb), (kp, vp) = right[spec.right_attr], left[spec.left_attr]
        if spec.key_dtype is not None:
            kb, vb = _normalize_key(kb, vb, spec.key_dtype)
            kp, vp = _normalize_key(kp, vp, spec.key_dtype)

        live = None
        if spec.strategy == "empty":
            bidx = jnp.zeros(spec.out_pad, jnp.int32)
            pidx = jnp.zeros(spec.out_pad, jnp.int32)
            live = jnp.zeros(spec.out_pad, bool)
            total = jnp.zeros((), jnp.int64)
        elif spec.strategy == "unique_scatter":
            (base,) = aux_args[spec.aux_id]
            bidx, found, total = join_ops.join_unique_scatter_impl(
                kb, vb, kp, vp, base, spec.r_pad
            )
            pidx, live = None, found
        elif spec.strategy == "unique_sort":
            bidx, found, total = join_ops.join_unique_impl(kb, vb, kp, vp)
            pidx, live = None, found
        elif spec.strategy == "csr":
            base, counts_w, starts_w, grouped = aux_args[spec.aux_id]
            bidx, pidx, live, total = join_ops.join_csr_impl(
                counts_w, starts_w, grouped, kp, vp, base, spec.out_pad
            )
        elif spec.strategy == "csr_swapped":
            # the *probe* child is the CSR-indexed scan: the build side's
            # keys go through the kernel's probe role, so the kernel's
            # bidx addresses probe rows and its pidx build rows
            base, counts_w, starts_w, grouped = aux_args[spec.aux_id]
            pidx, bidx, live, total = join_ops.join_csr_impl(
                counts_w, starts_w, grouped, kb, vb, base, spec.out_pad
            )
        elif spec.strategy in ("dev_csr", "dev_csr_swapped"):
            aux = aux_args[spec.aux_id]
            if spec.key_dtype is DataType.VARCHAR:
                # dictionary ids -> unified id space, then join as ints
                base, rb_map, rp_map = aux
                kb = _remap_ids(kb, rb_map)
                kp = _remap_ids(kp, rp_map)
            else:
                (base,) = aux
            if spec.strategy == "dev_csr":
                bidx, pidx, live, total = join_ops.join_dev_csr_impl(
                    kb, vb, kp, vp, base, spec.r_pad, spec.out_pad
                )
            else:
                # probe child is the device-indexed side (same role swap
                # as csr_swapped): kernel bidx -> probe rows, pidx ->
                # build rows
                pidx, bidx, live, total = join_ops.join_dev_csr_impl(
                    kp, vp, kb, vb, base, spec.r_pad, spec.out_pad
                )
        else:  # "merge": both children intermediate — single-sort join
            # materialize by carrying payload planes through the join's
            # single sort: no input-size pre-gathers on this path
            need: Dict[Tuple[int, int], Tuple] = {}
            b_keys, p_keys = [], []
            for side, ci in spec.out_cols:
                key = (side, ci)
                if key in need:
                    continue
                src = (left if side == 0 else right)[ci]
                need[key] = src
                on_build = (side == 0) == spec.build_left
                (b_keys if on_build else p_keys).append(key)
            out_bm, out_pm, live, total = join_ops.join_merge_full_impl(
                kb, vb, kp, vp, spec.out_pad,
                [need[k] for k in b_keys], [need[k] for k in p_keys],
            )
            totals.append(total)
            got = dict(zip(b_keys, out_bm))
            got.update(zip(p_keys, out_pm))
            tables[idx] = [got[key] for key in spec.out_cols]
            continue
        totals.append(total)

        lidx = bidx if spec.build_left else pidx
        ridx = pidx if spec.build_left else bidx
        gathered: Dict[Tuple[int, int], Tuple] = {}
        # batch the payload gathers per index stream: all columns riding
        # one stream go through ONE _gather_cols call
        by_stream: Dict[int, list] = {}
        for side, ci in spec.out_cols:
            key = (side, ci)
            if key in gathered or key in (k for g in by_stream.values()
                                          for k in g):
                continue
            src = (left if side == 0 else right)[ci]
            idx_arr = lidx if side == 0 else ridx
            if idx_arr is None:  # unique path: probe side passes through
                gathered[key] = (src[0], src[1] & live)
            else:
                by_stream.setdefault(id(idx_arr), []).append(key)
        for _sid, keys in by_stream.items():
            side0, ci0 = keys[0]
            idx_arr = lidx if side0 == 0 else ridx
            cols_in = [
                (left if s == 0 else right)[c] for s, c in keys
            ]
            g = _ex._gather_cols(cols_in, idx_arr, live)
            gathered.update(zip(keys, g))
        out_cols = [gathered[key] for key in spec.out_cols]
        if spec.compact_pad:
            # cardinality feedback: compact the probe-shaped output to
            # its learned size inside the program, so every downstream
            # stage runs at live-row scale
            out_cols = list(
                _ex._compact_probe_shaped(
                    tuple(out_cols), live, spec.compact_pad
                )
            )
        tables[idx] = out_cols

    root_cols = tables[plan.root]
    out_values = tuple(c[0] for c in root_cols)
    out_valid = tuple(c[1] for c in root_cols)
    totals_arr = (
        jnp.stack(totals) if totals else jnp.zeros(0, dtype=jnp.int64)
    )
    return out_values, out_valid, totals_arr


# Join-strategy observability (fused analogue of executor.path_stats):
# tallied per successful _execute_fused run by the engine.
PATH_STATS: Dict[str, int] = {}


def count_paths(structure: "FusedPlan") -> None:
    for spec in structure.join_specs.values():
        PATH_STATS[spec.strategy] = PATH_STATS.get(spec.strategy, 0) + 1


def path_stats() -> Dict[str, int]:
    return dict(PATH_STATS)


class _Ref:
    """Hashable-by-key wrapper so lru_cache can key on the structure."""

    def __init__(self, value, key):
        self.value = value
        self.key = key

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, _Ref) and self.key == other.key


@functools.lru_cache(maxsize=512)
def _compiled(cache_key, ref):
    structure = ref.value

    def fn(col_args, aux_args):
        return _trace(structure, col_args, aux_args)

    return jax.jit(fn)


def _trace_env_key() -> tuple:
    """Trace-time settings that change the exported program; they key
    the on-disk export cache (an export is specific to its platform, and
    CPU and GPU runs may share one cache directory)."""
    return (
        ("x64", bool(jax.config.jax_enable_x64)),
        ("platform", jax.default_backend()),
    )


@functools.lru_cache(maxsize=1)
def _code_fingerprint() -> str:
    """Content hash of every source file that shapes a traced program.
    Keys the on-disk exported-program cache: a kernel/compiler edit
    invalidates every cached export (a stale export would silently run
    old program semantics).

    The file set is the TRACED closure only — ops/* (kernels),
    plan/fused.py (_trace), plan/executor.py (_gather_cols /
    _compact_probe_shaped), dtypes.py (key semantics). engine.py and
    plan/ir.py are deliberately excluded: both are host-side
    orchestration — the plan structure they build is fully captured in
    the structure ``cache_key`` and the aval signature, so edits to them
    cannot change the traced computation under a fixed key."""
    import hashlib

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha1()
    files = []
    d = os.path.join(pkg, "ops")
    files.extend(
        os.path.join(d, f) for f in sorted(os.listdir(d))
        if f.endswith(".py")
    )
    files.append(os.path.abspath(__file__))
    files.append(os.path.join(pkg, "plan", "executor.py"))
    files.append(os.path.join(pkg, "dtypes.py"))
    for f in files:
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _export_dir():
    cache_dir = jax.config.jax_compilation_cache_dir
    if not cache_dir:
        return None
    d = os.path.join(cache_dir, "rjt_export")
    os.makedirs(d, exist_ok=True)
    return d


@functools.lru_cache(maxsize=512)
def _exported(cache_key, aval_key, ref, env_key=None):
    """jitted wrapper around a (disk-cached) jax.export'ed program.

    Re-tracing + lowering every fused query program is single-threaded
    Python work per process. The StableHLO is process-invariant, so it
    is exported ONCE and serialized next to the XLA compile cache; later
    processes deserialize it and compile via the persistent cache. The
    wrapper is jitted so steady-state dispatch rides the C++ fast path
    instead of Exported.call's Python re-embedding. Falls back to the
    plain jit on any export failure."""
    structure = ref.value

    def fn(col_args, aux_args):
        return _trace(structure, col_args, aux_args)

    d = _export_dir()
    exp = None
    if d is not None:
        import hashlib

        name = hashlib.sha1(
            repr((_code_fingerprint(), _trace_env_key(), cache_key,
                  aval_key)).encode()
        ).hexdigest()
        path = os.path.join(d, f"{name}.bin")
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    exp = jax.export.deserialize(f.read())
            except Exception:  # noqa: BLE001 - corrupt entry: re-export
                exp = None
        if exp is None:
            try:
                col_avals, aux_avals = aval_key
                exp = jax.export.export(jax.jit(fn))(col_avals, aux_avals)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(exp.serialize())
                os.replace(tmp, path)
            except Exception:  # noqa: BLE001 - unexportable program
                exp = None
    if exp is None:
        return jax.jit(fn)
    return jax.jit(exp.call)


def compile_plan(structure: FusedPlan):
    key = structure.cache_key()
    return _exported(key, _avals_of(structure), _Ref(structure, key),
                     _trace_env_key())


def _avals_of(structure: FusedPlan):
    col = tuple(
        (jax.ShapeDtypeStruct(d.shape, d.dtype),
         jax.ShapeDtypeStruct(v.shape, v.dtype))
        for d, v in structure.col_args
    )
    aux = tuple(
        tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in aux)
        for aux in structure.aux_args
    )
    return col, aux


@functools.lru_cache(maxsize=512)
def _compiled_exec(cache_key, aval_key, ref, env_key=None):
    # AOT-compile the SAME (exported-program) wrapper execution uses, so
    # the persistent-cache entry this warms is the one the jit path hits
    fn = _exported(cache_key, aval_key, ref, env_key)
    col_avals, aux_avals = aval_key
    return fn.lower(col_avals, aux_avals).compile()


def compiled_plan(structure: FusedPlan):
    """AOT-compiled executable for ``structure``.

    Memoizes the *compiled executable itself*, keyed by (structure, aval
    signature), so precompile and the first execution share one compile
    and one device load. The persistent XLA disk cache still backs
    cross-process reuse."""
    key = structure.cache_key()
    return _compiled_exec(key, _avals_of(structure), _Ref(structure, key),
                          _trace_env_key())
