"""Single-device equi-join kernels (JAX/XLA).

The reference joins by building a per-bucket open-addressing hash table and
walking per-slot ``std::vector`` duplicate chains (reference
src/execute.cpp:190-250). That shape is hostile to a vector machine. The
formulation used here is fully data-parallel and static-shaped:

1. **Order the build side** with a lexicographic ``lax.sort`` over
   ``(invalid, key)`` — NULL/padding rows sink to the tail, duplicates become
   contiguous runs (this is the radix/partitioning step collapsed to its
   limit: a full ordering).
2. **Probe by vectorized binary search**: for every probe key, ``lo/hi =
   searchsorted(build_keys)`` bound its duplicate run; ``count = hi - lo``.
   This replaces pointer-chasing with O(log B) batched gathers.
3. **Count-then-materialize**: join fan-out is data-dependent, which XLA's
   static shapes cannot express. We run the count kernel, sync the scalar
   total to the host, and materialize into a pow2-padded output
   (count+exact-allocation is the standard two-phase fix; the reference
   instead reallocates vectors per row, which made it allocator-bound —
   SURVEY.md §3.2).
4. **Expansion** of duplicate matches uses a searchsorted over the exclusive
   offsets (a segmented "repeat" — replaces the reference's per-slot
   ``slot_idxs`` vectors, src/execute.cpp:232-243).

NULL-key semantics: rows with ``valid == False`` never match (inner join
drops NULL keys, reference src/execute.cpp:62-83).

All kernels are shape-polymorphic only through the jit cache: callers pad
inputs to pow2 buckets (:func:`bucket_size`) so compilation count stays
bounded and the persistent compilation cache stays hot.

Index math is int32: all per-device positions fit i32 by construction
(a padded bucket of 2^31 rows of the narrowest payload, 5 B, would exceed
any device's memory), and i32 index streams halve the bytes every
scan/cumsum/gather moves. Scalars that cross the device boundary
(``total``) stay int64.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

MIN_BUCKET = 128


def gather_expand_multi(tables, pos):
    """``[t[pos] for t in tables]`` for equal-length tables sharing one
    index stream (any dtype: i32, i64 and bool planes gather directly).
    ``pos`` must already be clamped to [0, len)."""
    tables = list(tables)
    n0 = tables[0].shape[0]
    assert all(t.shape[0] == n0 for t in tables), "equal lengths required"
    return [t[pos] for t in tables]


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    """Smallest power of two >= max(n, minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def pad_1d(arr: jnp.ndarray, size: int, fill=0) -> jnp.ndarray:
    if arr.shape[0] == size:
        return arr
    if arr.shape[0] > size:
        raise ValueError("cannot pad down")
    return jnp.pad(arr, (0, size - arr.shape[0]), constant_values=fill)


def join_count_impl(
    build_keys: jnp.ndarray,
    build_valid: jnp.ndarray,
    probe_keys: jnp.ndarray,
    probe_valid: jnp.ndarray,
):
    """Count pass.

    Inputs are padded: ``build_keys``/``build_valid`` shape (Bp,),
    ``probe_keys``/``probe_valid`` shape (Pp,), with padding rows invalid.

    Returns ``(perm, lo, counts, offsets, total)``:
      * ``perm``   (Bp,)  int32 — original build row id at each sorted slot
      * ``lo``     (Pp,)  int64 — start of the matching build run per probe
      * ``counts`` (Pp,)  int64 — matches per probe row (0 if invalid)
      * ``offsets``(Pp,)  int64 — exclusive prefix sum of counts
      * ``total``  ()     int64 — output cardinality
    """
    bp = build_keys.shape[0]
    invalid = (~build_valid).astype(jnp.uint8)
    iota = jnp.arange(bp, dtype=jnp.int32)
    # Lexicographic sort by (invalid, key): valid rows first, key-ordered.
    _, keys_sorted, perm = jax.lax.sort(
        (invalid, build_keys, iota), num_keys=2
    )
    nvalid = jnp.sum(build_valid, dtype=jnp.int32)
    # The invalid tail holds arbitrary key values; overwrite with the dtype
    # max so the array is globally sorted for searchsorted. A real key equal
    # to the max is still counted exactly because lo/hi are clamped to
    # nvalid below.
    pos = jnp.arange(bp, dtype=jnp.int32)
    maxval = jnp.array(jnp.iinfo(build_keys.dtype).max, dtype=build_keys.dtype)
    keys_search = jnp.where(pos < nvalid, keys_sorted, maxval)
    # sort-based searchsorted: one co-sort instead of log2(B) rounds of
    # dependent gathers
    lo = jnp.searchsorted(
        keys_search, probe_keys, side="left", method="sort"
    ).astype(jnp.int32)
    hi = jnp.searchsorted(
        keys_search, probe_keys, side="right", method="sort"
    ).astype(jnp.int32)
    lo = jnp.minimum(lo, nvalid)
    hi = jnp.minimum(hi, nvalid)
    counts = jnp.where(probe_valid, hi - lo, 0)
    offsets = jnp.cumsum(counts) - counts  # exclusive prefix sum
    total = jnp.sum(counts, dtype=jnp.int64)
    return perm, lo, counts, offsets, total


def join_expand_impl(
    perm: jnp.ndarray,
    lo: jnp.ndarray,
    offsets: jnp.ndarray,
    total: jnp.ndarray,
    s_pad: int,
):
    """Expansion pass: output position -> (build_row, probe_row, live).

    For output slot j, the owning probe row is the last i with
    ``offsets[i] <= j`` (zero-count probes share offsets with their
    successor; the last index of an equal-offset run is the one with
    matches). ``within = j - offsets[i]`` selects the duplicate, and
    ``perm[lo[i] + within]`` maps back to the original build row id.

    The owner lookup is a segmented broadcast: scatter each emitting probe's
    id at its output start, then a running max fills its run — two cheap
    vector ops instead of a per-slot binary search.
    """
    pp = offsets.shape[0]
    total32 = total.astype(jnp.int32)
    counts_nonzero = jnp.diff(jnp.append(offsets, total32)) > 0
    starts = jnp.where(counts_nonzero, offsets, s_pad)
    marker = jnp.full(s_pad + 1, -1, dtype=jnp.int32)
    marker = marker.at[starts].max(jnp.arange(pp, dtype=jnp.int32), mode="drop")
    pidx = jax.lax.cummax(marker[:s_pad])
    pidx = jnp.clip(pidx, 0, pp - 1)
    j = jnp.arange(s_pad, dtype=jnp.int32)
    within = j - offsets[pidx]
    bpos = jnp.clip(lo[pidx] + within, 0, perm.shape[0] - 1)
    bidx = perm[bpos]
    live = j < total32
    bidx = jnp.where(live, bidx, 0)
    pidx = jnp.where(live, pidx, 0)
    return bidx, pidx, live


def join_merge_impl(
    build_keys: jnp.ndarray,
    build_valid: jnp.ndarray,
    probe_keys: jnp.ndarray,
    probe_valid: jnp.ndarray,
    carry: Tuple[jnp.ndarray, ...] = (),
):
    """Single-sort merge join count: ONE co-sort of (build ++ probe) with
    segment scans, replacing the build sort + two sort-based searchsorteds
    of :func:`join_count_impl` (~45% less sort work — the dominant cost of
    a general join).

    ``carry``: optional combined-length (B+P) planes carried through the
    sort as extra ``lax.sort`` operands, so they come out in
    combined-sorted order without a separate (B+P)-size gather. When
    ``carry`` is non-empty the return gains a 6th element: the tuple of
    carried planes in combined-sorted order.

    Sorts the combined array by (invalid, key, side) carrying original row
    ids; builds precede probes within each equal-key run, so for a probe
    element at combined position ``pos`` with run start ``rs``:

      * ``count`` = builds in its run = (pos - rs) - (probes in [rs, pos))
        (equal for every probe of the run);
      * its matches occupy combined positions [rs, rs + count), whose
        carried ids are the original build rows.

    Output rows are ordered by sorted-probe position (join results are
    multisets; the harness comparator sorts rows, reference
    read_sql.cpp:1159-1222).

    Returns ``(ids_sorted, run_start, pos_is_probe_counts, offsets, total)``
    for :func:`join_expand_merge_impl`:
      * ``ids_sorted`` (B+P,) int32 — original row id per combined slot
      * ``run_start`` (B+P,) int64 — run start position per combined slot
      * ``counts``    (B+P,) int64 — matches per combined slot (0 for
        build/invalid slots)
      * ``offsets``   (B+P,) int64 — exclusive prefix sum of counts
      * ``total``     ()     int64
    """
    bp = build_keys.shape[0]
    pp = probe_keys.shape[0]
    n = bp + pp
    keys = jnp.concatenate([build_keys, probe_keys])
    valid = jnp.concatenate([build_valid, probe_valid])
    ids = jnp.concatenate(
        [
            jnp.arange(bp, dtype=jnp.int32),
            jnp.arange(pp, dtype=jnp.int32),
        ]
    )
    invalid64 = (~valid).astype(jnp.int64)
    side64 = jnp.concatenate(
        [jnp.zeros(bp, jnp.int64), jnp.ones(pp, jnp.int64)]
    )
    # Pack the whole sort problem into as few i64 lanes as possible: the
    # bitonic sort streams every operand through ~log^2(n) compare-
    # exchange passes, so operand count IS the cost. 32-bit keys pack
    # (invalid, key, side, id) into ONE i64 (5 operands -> 1); 64-bit
    # keys saturate invalid keys to +MAX and sort two i64 lanes.
    if keys.dtype == jnp.int32 and n < (1 << 29):
        # [62] invalid | [30..61] key (sign-biased) | [29] side | [0..28] id
        ukey = (keys.astype(jnp.int64) & jnp.int64(0xFFFFFFFF)) ^ jnp.int64(
            1 << 31
        )
        packed = (
            (invalid64 << 62) | (ukey << 30) | (side64 << 29)
            | ids.astype(jnp.int64)
        )
        packed_s, *carried = jax.lax.sort(
            (packed,) + tuple(carry), num_keys=1
        )
        ids_s = (packed_s & jnp.int64((1 << 29) - 1)).astype(jnp.int32)
        side_s = ((packed_s >> 29) & 1).astype(jnp.uint8)
        valid_s = (1 - ((packed_s >> 62) & 1)).astype(jnp.uint8)
        # run identity = key bits + invalid bit in one compare (the
        # valid->invalid boundary break rides the invalid bit)
        runkey = packed_s >> 30
    else:
        maxk = jnp.array(jnp.iinfo(keys.dtype).max, dtype=keys.dtype)
        keysat = jnp.where(valid, keys, maxk)
        # [33] invalid | [32] side | [0..31] id
        packed = (invalid64 << 33) | (side64 << 32) | ids.astype(jnp.int64)
        keysat_s, packed_s, *carried = jax.lax.sort(
            (keysat, packed) + tuple(carry), num_keys=2
        )
        ids_s = (packed_s & jnp.int64(0xFFFFFFFF)).astype(jnp.int32)
        side_s = ((packed_s >> 32) & 1).astype(jnp.uint8)
        valid_s = (1 - ((packed_s >> 33) & 1)).astype(jnp.uint8)
        # a valid key equal to the saturation value must not merge with
        # the invalid tail: fold the invalid bit into the run identity
        runkey = (keysat_s, (packed_s >> 33) & 1)

    pos = jnp.arange(n, dtype=jnp.int32)

    def _changed(a):
        return jnp.concatenate([a[:1], a[:-1]]) != a

    if isinstance(runkey, tuple):
        new_run = _changed(runkey[0]) | _changed(runkey[1])
    else:
        new_run = _changed(runkey)
    is_start = (pos == 0) | new_run
    run_start = jax.lax.cummax(jnp.where(is_start, pos, jnp.int32(0)))
    is_probe = (side_s == 1).astype(jnp.int32)
    probe_excl = jnp.cumsum(is_probe) - is_probe
    # probe_excl at each run start, broadcast across the run (monotone, so
    # a running max of start-masked values is exact)
    probe_at_start = jax.lax.cummax(jnp.where(is_start, probe_excl, jnp.int32(0)))
    builds_in_run = (pos - run_start) - (probe_excl - probe_at_start)
    counts = jnp.where((is_probe == 1) & (valid_s == 1), builds_in_run, 0)
    offsets = jnp.cumsum(counts) - counts
    total = jnp.sum(counts, dtype=jnp.int64)
    if carry:
        return ids_s, run_start, counts, offsets, total, tuple(carried)
    return ids_s, run_start, counts, offsets, total


def _merge_owner_recovery(offsets, total, s_pad: int):
    """Shared scatter-max owner recovery over combined positions:
    ``owner[j]`` = combined slot owning output j (monotone), plus the
    live mask. Same formulation as :func:`join_expand_impl`."""
    n = offsets.shape[0]
    total32 = total.astype(jnp.int32)
    counts_nonzero = jnp.diff(jnp.append(offsets, total32)) > 0
    starts = jnp.where(counts_nonzero, offsets, s_pad)
    marker = jnp.full(s_pad + 1, -1, dtype=jnp.int32)
    marker = marker.at[starts].max(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    owner = jnp.clip(jax.lax.cummax(marker[:s_pad]), 0, n - 1)
    j = jnp.arange(s_pad, dtype=jnp.int32)
    live = j < total32
    return owner, j, live


def join_expand_merge_impl(
    ids_sorted: jnp.ndarray,
    run_start: jnp.ndarray,
    offsets: jnp.ndarray,
    total: jnp.ndarray,
    s_pad: int,
):
    """Expansion for the merge join: output slot j -> (build_row,
    probe_row, live). Same scatter-max owner recovery as
    :func:`join_expand_impl`, but over combined positions; the
    owner-indexed lookups (offsets/run_start/ids_sorted) share one index
    stream."""
    n = offsets.shape[0]
    owner, j, live = _merge_owner_recovery(offsets, total, s_pad)
    offs_g, rs_g, pidx = gather_expand_multi(
        [offsets, run_start, ids_sorted], owner
    )
    within = j - offs_g
    bpos = jnp.clip(rs_g + within, 0, n - 1)
    bidx = ids_sorted[bpos]
    bidx = jnp.where(live, bidx, 0)
    pidx = jnp.where(live, pidx, 0)
    return bidx, pidx, live


def join_merge_full_impl(
    build_keys: jnp.ndarray,
    build_valid: jnp.ndarray,
    probe_keys: jnp.ndarray,
    probe_valid: jnp.ndarray,
    s_pad: int,
    build_cols,
    probe_cols,
):
    """Merge join end-to-end — count, expansion, and late
    materialization.

    The payload columns ride the join's single ``lax.sort`` as carried
    operands (:func:`join_merge_impl` ``carry``), so they come out in
    combined-sorted order without a (B+P)-size gather. After the sort
    everything is position-local: build payloads are read through the
    ``bpos`` stream and probe payloads through the ``owner`` stream,
    sharing those streams with the expansion's own offsets/run_start
    lookups.

    ``build_cols`` / ``probe_cols``: sequences of (data, valid) device
    arrays (i32/i64 data). Returns ``(out_build, out_probe, live,
    total)`` with outputs as (data, valid & live) in the ``s_pad``
    bucket — exact multiset semantics of gathering by (bidx, pidx).

    Replaces the reference's per-row projection loop
    (src/execute.cpp:236-243) — late materialization at full vector
    width, reference semantics (padding rows carry valid=False).
    """
    bp = build_keys.shape[0]
    pp = probe_keys.shape[0]
    b_planes = [a for col in build_cols for a in col]
    p_planes = [a for col in probe_cols for a in col]
    # combined-length planes: the other side's half is don't-care (build
    # planes are only ever read at build slots via bpos, probe planes at
    # probe slots via owner)
    carry = tuple(
        jnp.concatenate([pl, jnp.zeros(pp, pl.dtype)]) for pl in b_planes
    ) + tuple(
        jnp.concatenate([jnp.zeros(bp, pl.dtype), pl]) for pl in p_planes
    )
    merged = join_merge_impl(
        build_keys, build_valid, probe_keys, probe_valid, carry
    )
    run_start, offsets, total = merged[1], merged[3], merged[4]
    carried = merged[5] if carry else ()
    n = offsets.shape[0]
    owner, j, live = _merge_owner_recovery(offsets, total, s_pad)
    nb = len(b_planes)

    # owner stream: expansion lookups + every probe payload plane
    got = gather_expand_multi(
        [offsets, run_start] + list(carried[nb:]), owner
    )
    offs_g, rs_g, p_got = got[0], got[1], got[2:]
    within = j - offs_g
    bpos = jnp.clip(rs_g + within, 0, n - 1)
    # bpos stream: every build payload plane
    b_got = gather_expand_multi(carried[:nb], bpos) if nb else []

    def _pairs(planes):
        return [
            (planes[i], planes[i + 1] & live)
            for i in range(0, len(planes), 2)
        ]

    return _pairs(b_got), _pairs(p_got), live, total


def join_unique_impl(
    build_keys: jnp.ndarray,
    build_valid: jnp.ndarray,
    probe_keys: jnp.ndarray,
    probe_valid: jnp.ndarray,
):
    """FK->PK fast path: build keys are pairwise distinct among valid rows.

    With a unique build side every probe row matches at most once, so the
    whole count/offsets/expansion machinery (and its host sync for the
    output bucket) is statically unnecessary: the output stays
    **probe-shaped** — row j of the output corresponds to probe row j, with
    ``found[j]`` False for non-matching rows. Callers thread ``found`` into
    the validity masks; dead rows can never match or emit downstream.

    Returns ``(bidx, found, total)``: build row id per probe row (0 where
    not found), the match mask, and the exact match count.
    """
    bp = build_keys.shape[0]
    invalid = (~build_valid).astype(jnp.uint8)
    iota = jnp.arange(bp, dtype=jnp.int32)
    _, keys_sorted, perm = jax.lax.sort(
        (invalid, build_keys, iota), num_keys=2
    )
    nvalid = jnp.sum(build_valid, dtype=jnp.int32)
    pos = jnp.arange(bp, dtype=jnp.int32)
    maxval = jnp.array(jnp.iinfo(build_keys.dtype).max, dtype=build_keys.dtype)
    keys_search = jnp.where(pos < nvalid, keys_sorted, maxval)
    lo = jnp.searchsorted(
        keys_search, probe_keys, side="left", method="sort"
    ).astype(jnp.int32)
    lo_c = jnp.minimum(lo, bp - 1)
    found = (
        probe_valid
        & (lo < nvalid)
        & (keys_search[lo_c] == probe_keys)
    )
    bidx = jnp.where(found, perm[lo_c], 0)
    total = jnp.sum(found, dtype=jnp.int64)
    return bidx, found, total


def join_unique_scatter_impl(
    build_keys: jnp.ndarray,
    build_valid: jnp.ndarray,
    probe_keys: jnp.ndarray,
    probe_valid: jnp.ndarray,
    base: jnp.ndarray,
    r_pad: int,
):
    """Sort-free FK->PK join via a dense key-range table.

    Applicable when the build side is *unique* (see
    :func:`join_unique_impl`) and its valid keys are known to lie in a
    static window ``[base, base + r_pad)`` — true for every FK->PK join in
    JOB, whose PK columns are dense integer ids (the executor derives the
    window from host-side column stats of the build scan). Instead of
    ordering anything, scatter each build row id into ``slots[key - base]``
    and look probes up with one gather:

        memset(r_pad) + scatter(B) + gather(P)

    — pure HBM-bandwidth work, replacing the build sort + co-sorted
    searchsorted of :func:`join_unique_impl` (the sort dominates
    mid-size joins). ``base`` is a
    traced scalar so one compiled program serves every query that shares
    shapes; only ``r_pad`` is static. Semantics match join_unique_impl exactly: NULL/invalid keys on
    either side never match (reference src/execute.cpp:62-83); out-of-window
    probe keys cannot match by construction.

    Returns ``(bidx, found, total)`` — probe-shaped, like join_unique_impl.
    """
    bp = build_keys.shape[0]
    # Window offsets fit i32 by construction (r_pad <= 2^26)
    off_b64 = build_keys.astype(jnp.int64) - base
    # invalid rows (incl. padding) -> r_pad, dropped by the scatter; all
    # *valid* build keys are in-window by construction of the caller.
    off_b = jnp.where(
        build_valid, jnp.clip(off_b64, 0, r_pad), r_pad
    ).astype(jnp.int32)
    slots = jnp.full(r_pad, -1, jnp.int32)
    slots = slots.at[off_b].set(
        jnp.arange(bp, dtype=jnp.int32), mode="drop"
    )
    off_p64 = probe_keys.astype(jnp.int64) - base
    in_window = (off_p64 >= 0) & (off_p64 < r_pad)
    off_p = jnp.clip(off_p64, 0, r_pad - 1).astype(jnp.int32)
    hit = slots[off_p]
    found = probe_valid & in_window & (hit >= 0)
    bidx = jnp.where(found, hit, 0)
    total = jnp.sum(found, dtype=jnp.int64)
    return bidx, found, total


def join_csr_impl(
    counts_w: jnp.ndarray,
    starts_w: jnp.ndarray,
    grouped: jnp.ndarray,
    probe_keys: jnp.ndarray,
    probe_valid: jnp.ndarray,
    base: jnp.ndarray,
    s_pad: int,
):
    """Sort-free general join against a host-pregrouped build side.

    The executor detects joins whose build child is a base-table scan and
    precomputes — once per column, on the host with numpy, memoized — a
    CSR index over the build key window ``[base, base + r_pad)``:

      * ``counts_w`` (r_pad,) i32 — valid build rows per key offset
      * ``starts_w`` (r_pad,) i32 — exclusive prefix sum of counts_w
      * ``grouped``  (g_pad,) i32 — build row ids grouped by key offset

    The device side is then pure gather/scan work — no ``lax.sort``
    anywhere: per probe, ``count/start = counts_w/starts_w[key - base]``; expansion
    reuses the scatter-max owner recovery of :func:`join_expand_impl` and
    maps within-run offsets through ``grouped``. Unlike the unique scatter
    table (:func:`join_unique_scatter_impl`) duplicates are fully
    supported; semantics match :func:`join_merge_impl` exactly (NULL keys
    never match, reference src/execute.cpp:62-83). Out-of-window probe
    keys have no matches by construction.

    Returns ``(bidx, pidx, live, total)`` in the ``s_pad`` bucket.
    ASYMMETRIC contract: ``bidx`` is zeroed on dead rows; ``pidx`` is
    NOT — it stays monotone/clamped across the whole pad
    (garbage-but-in-bounds where ``live`` is False). Mask by ``live``
    before reading ``pidx``.
    """
    r_pad = counts_w.shape[0]
    pp = probe_keys.shape[0]
    off_p64 = probe_keys.astype(jnp.int64) - base
    in_window = probe_valid & (off_p64 >= 0) & (off_p64 < r_pad)
    off_p = jnp.clip(off_p64, 0, r_pad - 1).astype(jnp.int32)
    cnt_i32, start_i32 = gather_expand_multi([counts_w, starts_w], off_p)
    cnt = jnp.where(in_window, cnt_i32, 0)
    start = start_i32
    offsets = jnp.cumsum(cnt) - cnt
    total = jnp.sum(cnt, dtype=jnp.int64)
    total32 = total.astype(jnp.int32)
    # owner recovery (same as join_expand_impl): scatter each emitting
    # probe's id at its output start, running max fills the run
    starts_out = jnp.where(cnt > 0, offsets, s_pad)
    marker = jnp.full(s_pad + 1, -1, dtype=jnp.int32)
    marker = marker.at[starts_out].max(
        jnp.arange(pp, dtype=jnp.int32), mode="drop"
    )
    pidx = jax.lax.cummax(marker[:s_pad])
    pidx = jnp.clip(pidx, 0, pp - 1)
    j = jnp.arange(s_pad, dtype=jnp.int32)
    offs_g, start_g = gather_expand_multi([offsets, start], pidx)
    within = j - offs_g
    gpos = jnp.clip(start_g + within, 0, grouped.shape[0] - 1)
    bidx = grouped[gpos]
    live = j < total32
    bidx = jnp.where(live, bidx, 0)
    # pidx is not zeroed on dead rows (the cummax keeps it in bounds);
    # dead rows are masked by ``live`` everywhere downstream
    return bidx, pidx, live, total


def join_dev_csr_impl(
    build_keys: jnp.ndarray,
    build_valid: jnp.ndarray,
    probe_keys: jnp.ndarray,
    probe_valid: jnp.ndarray,
    base: jnp.ndarray,
    r_pad: int,
    s_pad: int,
):
    """General join via a CSR index built **on device** over the key
    window ``[base, base + r_pad)``.

    The device-side generalization of :func:`join_csr_impl` for joins
    where *neither* child is a base-table scan (both intermediates), but
    the build key column's provenance is a base column with a known
    static window — true for every JOB join key, which descend from
    dense integer id columns (the fused compiler threads window
    provenance through ``col_sources``).

    The CSR arrays are computed with a histogram scatter-add + cumsum
    over the window, and ``grouped`` (build row ids ordered by key) with
    ONE sort of the build side only — versus the merge join's co-sort of
    ``build ++ probe`` with 5 carried operands. The probe side is pure
    window gathers. When the probe side is much larger than the build
    side (the common case after cardinality-feedback compaction) this
    removes most of the sort work that dominates general joins.

    Semantics match :func:`join_merge_impl` exactly: NULL/invalid keys
    never match (reference src/execute.cpp:62-83), duplicates fan out,
    out-of-window probe keys have no matches by construction (valid
    build keys are in-window by provenance).

    Returns ``(bidx, pidx, live, total)`` in the ``s_pad`` bucket, with
    :func:`join_csr_impl`'s asymmetric dead-row contract (bidx zeroed,
    pidx monotone/clamped garbage where ``live`` is False).
    """
    bp = build_keys.shape[0]
    off_b64 = build_keys.astype(jnp.int64) - base
    in_b = build_valid & (off_b64 >= 0) & (off_b64 < r_pad)
    off_b = jnp.where(in_b, off_b64, r_pad).astype(jnp.int32)
    counts_w = jnp.zeros(r_pad + 1, jnp.int32).at[off_b].add(
        1, mode="drop"
    )[:r_pad]
    starts_w = (jnp.cumsum(counts_w) - counts_w).astype(jnp.int32)
    iota = jnp.arange(bp, dtype=jnp.int32)
    # stable sort: in-window rows (off < r_pad) grouped by key offset at
    # the head, exactly the CSR layout starts_w indexes into
    _, grouped = jax.lax.sort((off_b, iota), num_keys=1)
    return join_csr_impl(
        counts_w, starts_w, grouped, probe_keys, probe_valid, base, s_pad
    )


join_count = jax.jit(join_count_impl)
join_expand = jax.jit(join_expand_impl, static_argnames=("s_pad",))


@jax.jit
def gather_columns(
    cols: List[Tuple[jnp.ndarray, jnp.ndarray]],
    idx: jnp.ndarray,
    live: jnp.ndarray,
):
    """Late materialization: gather (data, valid) pairs at ``idx``.

    Padding output rows get ``valid = False`` so they can never join or
    emit downstream.
    """
    out = []
    for data, valid in cols:
        out.append((data[idx], valid[idx] & live))
    return out


def join_count_and_index(build_keys, build_valid, probe_keys, probe_valid):
    """Host driver for the two-phase join: returns (bidx, pidx, live, total).

    Performs exactly one device->host sync (the scalar ``total``) to pick
    the static output bucket, mirroring count-then-materialize.
    """
    perm, lo, _counts, offsets, total_dev = join_count(
        build_keys, build_valid, probe_keys, probe_valid
    )
    total = int(total_dev)
    s_pad = bucket_size(total)
    bidx, pidx, live = join_expand(perm, lo, offsets, total_dev, s_pad)
    return bidx, pidx, live, total
