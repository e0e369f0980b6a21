"""Tests: multi-pass radix partitioned join + FK->PK unique-build fast path."""

import numpy as np
import pytest

from radixjoin.dtypes import DataType
from radixjoin.ops import radix
from radixjoin.plan.ir import Plan
from radixjoin.storage.columnar import ColumnarTable, HostColumn, HostTable
from radixjoin import engine


def ref_join(bk, bv, pk, pv):
    """Host-reference inner join: list of (build_row, probe_row)."""
    index = {}
    for i, (k, v) in enumerate(zip(bk, bv)):
        if v:
            index.setdefault(int(k), []).append(i)
    out = []
    for j, (k, v) in enumerate(zip(pk, pv)):
        if v:
            for i in index.get(int(k), ()):
                out.append((i, j))
    return sorted(out)


@pytest.mark.parametrize("num_partitions", [1, 4, 16])
def test_partitioned_join_exact(num_partitions):
    rng = np.random.default_rng(7)
    nb, npr = 500, 3000
    bk = rng.integers(0, 300, nb).astype(np.int64)
    bv = rng.random(nb) > 0.1
    pk = rng.integers(0, 400, npr).astype(np.int64)
    pv = rng.random(npr) > 0.1
    out = radix.partitioned_join(
        bk, bv, {"row": np.arange(nb, dtype=np.int64)},
        pk, pv, {"row": np.arange(npr, dtype=np.int64)},
        num_partitions=num_partitions,
    )
    got = sorted(zip(out["b.row"].tolist(), out["p.row"].tolist()))
    assert got == ref_join(bk, bv, pk, pv)


def test_partitioned_join_empty_and_skew():
    # all probe rows hit one hot key -> one partition takes everything
    bk = np.array([5, 9], dtype=np.int64)
    bv = np.ones(2, bool)
    pk = np.full(1000, 5, dtype=np.int64)
    pv = np.ones(1000, bool)
    out = radix.partitioned_join(
        bk, bv, {"r": np.arange(2, dtype=np.int64)},
        pk, pv, {"r": np.arange(1000, dtype=np.int64)},
        num_partitions=8,
    )
    assert len(out["p.r"]) == 1000
    assert (out["b.r"] == 0).all()

    # empty inputs
    out = radix.partitioned_join(
        np.zeros(0, np.int64), np.zeros(0, bool), {"r": np.zeros(0, np.int64)},
        pk, pv, {"r": np.arange(1000, dtype=np.int64)},
        num_partitions=4,
    )
    assert len(out["b.r"]) == 0 and len(out["p.r"]) == 0


def test_choose_num_partitions_budget():
    # 1M+1M rows at 16B with a 4MiB budget -> needs >=8 partitions
    p = radix.choose_num_partitions(1 << 20, 1 << 20, 16, budget_bytes=4 << 20)
    assert p >= 8 and (p & (p - 1)) == 0
    assert radix.choose_num_partitions(10, 10, 16, budget_bytes=1 << 30) == 1


def _make_table(cols):
    host = HostTable(len(cols[0][1]), [
        HostColumn(dt, np.asarray(vals, dtype=dt.numpy_dtype), np.asarray(valid))
        for dt, vals, valid in cols
    ])
    return ColumnarTable.from_host(host)


def _fk_pk_plan(unique_pk=True):
    """dim(pk unique) join fact(fk) with a second join on top so the
    unique join is non-root (the fast path excludes the root)."""
    plan = Plan()
    pk_vals = [1, 2, 3, 4, 5] if unique_pk else [1, 2, 2, 4, 5]
    dim = _make_table([
        (DataType.INT32, pk_vals, [True] * 5),
        (DataType.INT64, [10, 20, 30, 40, 50], [True] * 5),
    ])
    fact = _make_table([
        (DataType.INT32, [2, 2, 3, 7, 1, 2], [True, True, True, True, False, True]),
        (DataType.INT32, [100, 101, 102, 103, 104, 105], [True] * 6),
    ])
    top = _make_table([
        (DataType.INT32, [100, 102, 105, 105], [True] * 4),
    ])
    t_dim = plan.new_input(dim)
    t_fact = plan.new_input(fact)
    t_top = plan.new_input(top)
    s_dim = plan.new_scan_node(t_dim, [(0, DataType.INT32), (1, DataType.INT64)])
    s_fact = plan.new_scan_node(t_fact, [(0, DataType.INT32), (1, DataType.INT32)])
    s_top = plan.new_scan_node(t_top, [(0, DataType.INT32)])
    # join1: build dim (unique pk), probe fact on fk
    j1 = plan.new_join_node(
        True, s_dim, s_fact, 0, 0,
        [(1, DataType.INT64), (3, DataType.INT32)],  # dim.val, fact.tag
    )
    # join2 (root): top.tag = j1.tag
    j2 = plan.new_join_node(
        False, j1, s_top, 1, 0,
        [(0, DataType.INT64), (1, DataType.INT32)],
    )
    plan.root = j2
    return plan


@pytest.mark.parametrize("unique_pk", [True, False])
def test_fused_unique_fast_path_matches(unique_pk):
    plan = _fk_pk_plan(unique_pk)
    detected = engine._detect_unique_joins(plan)
    if unique_pk:
        assert len(detected) == 1  # join1 eligible, root excluded
    else:
        assert len(detected) == 0

    result = engine.execute(plan)
    host = result.to_host()
    rows = sorted(
        (int(host.columns[0].values[i]), int(host.columns[1].values[i]))
        for i in range(host.num_rows)
    )
    # expected: fact rows with fk in dim (valid only), then tag joined to top
    # pk values map to dim.val; duplicate pk 2 fans out when not unique
    vals = {1: [10], 2: [20], 3: [30], 4: [40], 5: [50]} if unique_pk else \
           {1: [10], 2: [20, 30], 4: [40], 5: [50]}
    fact_rows = [(2, 100), (2, 101), (3, 102), (2, 105)]  # valid (fk, tag)
    j1 = [(v, tag) for fk, tag in fact_rows for v in vals.get(fk, [])]
    expected = [
        (val, tag) for val, tag in j1 for t in [100, 102, 105, 105] if t == tag
    ]
    assert rows == sorted(expected)


def test_host_partitioned_executor_matches_fused(monkeypatch):
    """Force the out-of-HBM path with a tiny budget; result must be
    row-identical (as a multiset) to the fused device path."""
    plan = _fk_pk_plan(unique_pk=False)
    normal = engine.execute(plan).to_host()
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", "1")  # everything "oversized"
    spilled = engine.execute(plan).to_host()

    def rows(host):
        return sorted(
            tuple(
                (None if not host.columns[c].valid[i]
                 else host.columns[c].values[i].item())
                for c in range(len(host.columns))
            )
            for i in range(host.num_rows)
        )

    assert spilled.num_rows == normal.num_rows
    assert rows(spilled) == rows(normal)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_join_kernel_matches_reference(seed):
    """join_merge_impl + join_expand_merge_impl produce the exact multiset
    of (build_row, probe_row) pairs, incl. NULLs and duplicate keys."""
    import jax.numpy as jnp
    from radixjoin.ops import join as join_ops

    rng = np.random.default_rng(seed)
    nb, npr = 300, 900
    bk = rng.integers(0, 150, nb).astype(np.int64)
    bv = rng.random(nb) > 0.15
    pk = rng.integers(0, 200, npr).astype(np.int64)
    pv = rng.random(npr) > 0.15
    # adversarial: an invalid build row carrying a key that exists validly
    bk[0] = bk[1]
    bv[0] = False

    bpad = join_ops.bucket_size(nb)
    ppad = join_ops.bucket_size(npr)
    kb = join_ops.pad_1d(jnp.asarray(bk), bpad)
    vb = join_ops.pad_1d(jnp.asarray(bv), bpad)
    kp = join_ops.pad_1d(jnp.asarray(pk), ppad)
    vp = join_ops.pad_1d(jnp.asarray(pv), ppad)

    ids_s, run_start, _c, offsets, total = join_ops.join_merge_impl(
        kb, vb, kp, vp
    )
    s_pad = join_ops.bucket_size(int(total))
    bidx, pidx, live = join_ops.join_expand_merge_impl(
        ids_s, run_start, offsets, total, s_pad
    )
    live_np = np.asarray(live)
    got = sorted(zip(
        np.asarray(bidx)[live_np].tolist(), np.asarray(pidx)[live_np].tolist()
    ))
    assert got == ref_join(bk, bv, pk, pv)


def test_unique_key_memo():
    col = HostColumn(DataType.INT32, np.array([3, 1, 2], np.int32),
                     np.ones(3, bool))
    assert col.is_unique_key()
    dup = HostColumn(DataType.INT32, np.array([3, 1, 3], np.int32),
                     np.ones(3, bool))
    assert not dup.is_unique_key()
    # NULL rows may repeat values without breaking uniqueness
    nulls = HostColumn(DataType.INT32, np.array([3, 3, 2], np.int32),
                       np.array([True, False, True]))
    assert nulls.is_unique_key()
    # sorted-detection shortcut
    sorted_col = HostColumn(DataType.INT64, np.arange(100, dtype=np.int64),
                            np.ones(100, bool))
    assert sorted_col.is_unique_key()


@pytest.mark.parametrize("seed", [0, 1])
def test_unique_scatter_kernel_matches_sort_path(seed):
    """join_unique_scatter_impl == join_unique_impl on unique build keys,
    incl. NULLs on both sides, out-of-window probe keys, negative keys."""
    import jax.numpy as jnp
    from radixjoin.ops import join as join_ops

    rng = np.random.default_rng(seed)
    nb, npr = 200, 1500
    bk = rng.permutation(np.arange(-50, 400, dtype=np.int64))[:nb]
    bv = rng.random(nb) > 0.1
    pk = rng.integers(-200, 700, npr).astype(np.int64)  # many out-of-window
    pv = rng.random(npr) > 0.1
    # adversarial: an invalid build row duplicating a valid row's key
    bk[0] = bk[1]
    bv[0] = False

    bpad = join_ops.bucket_size(nb)
    ppad = join_ops.bucket_size(npr)
    kb = join_ops.pad_1d(jnp.asarray(bk), bpad)
    vb = join_ops.pad_1d(jnp.asarray(bv), bpad)
    kp = join_ops.pad_1d(jnp.asarray(pk), ppad)
    vp = join_ops.pad_1d(jnp.asarray(pv), ppad)

    valid_vals = bk[bv]
    base = int(valid_vals.min())
    r_pad = join_ops.bucket_size(int(valid_vals.max()) - base + 1)
    bidx_s, found_s, total_s = join_ops.join_unique_scatter_impl(
        kb, vb, kp, vp, np.int64(base), r_pad
    )
    bidx_r, found_r, total_r = join_ops.join_unique_impl(kb, vb, kp, vp)
    assert int(total_s) == int(total_r)
    np.testing.assert_array_equal(np.asarray(found_s), np.asarray(found_r))
    f = np.asarray(found_r)
    np.testing.assert_array_equal(np.asarray(bidx_s)[f], np.asarray(bidx_r)[f])
    # and both match the host reference join
    got = sorted(
        (int(b), int(p))
        for b, p in zip(
            np.asarray(bidx_s)[f], np.nonzero(f)[0]
        )
    )
    assert got == ref_join(bk, bv, pk, pv)


def test_valid_range_memo():
    col = HostColumn(
        DataType.INT32,
        np.array([7, -3, 100, 5], np.int32),
        np.array([True, True, False, True]),
    )
    assert col.valid_range() == (-3, 7)  # invalid 100 excluded
    empty = HostColumn(DataType.INT32, np.array([9], np.int32),
                       np.array([False]))
    assert empty.valid_range() is None


@pytest.mark.parametrize("seed", [0, 3])
def test_csr_join_kernel_matches_merge_path(seed):
    """join_csr_impl == join_merge_impl: duplicates on both sides, NULLs,
    out-of-window probe keys, negative keys, zero-count probes."""
    import jax.numpy as jnp
    from radixjoin.ops import join as join_ops
    from radixjoin.storage.columnar import HostColumn

    rng = np.random.default_rng(seed)
    nb, npr = 300, 900
    bk = rng.integers(-40, 120, nb).astype(np.int64)  # heavy duplicates
    bv = rng.random(nb) > 0.15
    pk = rng.integers(-200, 400, npr).astype(np.int64)  # many out-of-window
    pv = rng.random(npr) > 0.1

    hcol = HostColumn(DataType.INT64, bk, bv)
    base, counts_w, starts_w, grouped = hcol.csr_index()

    ppad = join_ops.bucket_size(npr)
    kp = join_ops.pad_1d(jnp.asarray(pk), ppad)
    vp = join_ops.pad_1d(jnp.asarray(pv), ppad)

    expected = ref_join(bk, bv, pk, pv)
    s_pad = join_ops.bucket_size(len(expected))
    bidx, pidx, live, total = join_ops.join_csr_impl(
        jnp.asarray(counts_w), jnp.asarray(starts_w), jnp.asarray(grouped),
        kp, vp, jnp.int64(base), s_pad,
    )
    assert int(total) == len(expected)
    lv = np.asarray(live)
    got = sorted(zip(np.asarray(bidx)[lv].tolist(),
                     np.asarray(pidx)[lv].tolist()))
    assert got == expected


def test_csr_index_memo_and_gates():
    # empty-valid column: sentinel empty index, never matches
    empty = HostColumn(DataType.INT32, np.array([9], np.int32),
                       np.array([False]))
    base, counts_w, _s, _g = empty.csr_index()
    assert base == 0 and counts_w.sum() == 0
    # non-int column: None
    f = HostColumn(DataType.FP64, np.array([1.5]), np.array([True]))
    assert f.csr_index() is None
    # window wider than cap: None
    wide = HostColumn(
        DataType.INT64, np.array([0, 1 << 40], np.int64), np.ones(2, bool)
    )
    assert wide.csr_index() is None
    # grouping correctness with duplicates + invalid rows
    col = HostColumn(
        DataType.INT32,
        np.array([7, 5, 7, 6, 5], np.int32),
        np.array([True, True, True, False, True]),
    )
    base, counts_w, starts_w, grouped = col.csr_index()
    assert base == 5
    assert counts_w[:3].tolist() == [2, 0, 2]  # keys 5,6,7 (6: invalid only)
    assert grouped[:4].tolist() == [1, 4, 0, 2]  # 5s in row order, then 7s


def test_join_path_stats_counters(monkeypatch):
    """PATH_STATS records which kernel family each executed join used
    (wave-executor counters: pin the mode — the default is fused)."""
    monkeypatch.setenv("RJT_EXEC_MODE", "shared")
    from radixjoin.plan import executor
    from radixjoin import engine
    from radixjoin.plan.ir import Plan

    before = executor.path_stats()
    pk = HostTable(3, [HostColumn(DataType.INT32,
                                  np.array([1, 2, 3], np.int32),
                                  np.ones(3, bool))])
    fk = HostTable(4, [HostColumn(DataType.INT32,
                                  np.array([2, 2, 3, 9], np.int32),
                                  np.ones(4, bool))])
    plan = Plan()
    a = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(pk)),
                           [(0, DataType.INT32)])
    b = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(fk)),
                           [(0, DataType.INT32)])
    j1 = plan.new_join_node(True, a, b, 0, 0, [(0, DataType.INT32)])
    # second PK table joined on top: j1 is now an inner (non-root) join
    # and eligible for the unique fast path; the root join is always
    # compacted (general family) by design.
    pk2 = HostTable(3, [HostColumn(DataType.INT32,
                                   np.array([1, 2, 3], np.int32),
                                   np.ones(3, bool))])
    c = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(pk2)),
                           [(0, DataType.INT32)])
    plan.root = plan.new_join_node(True, c, j1, 0, 0, [(1, DataType.INT32)])
    res = engine.execute(plan, engine.build_context())
    assert res.num_rows == 3
    after = executor.path_stats()
    assert sum(after.values()) >= sum(before.values()) + 2
    assert any(k.startswith("unique_") for k, v in after.items()
               if v > before.get(k, 0))
    assert any(k.startswith("general_") for k, v in after.items()
               if v > before.get(k, 0))


def test_cardinality_feedback_repeat_and_stale(monkeypatch):
    """Second execution of a plan uses learned exact buckets; poisoned
    (stale/undersized) feedback must be detected and recomputed, never
    truncating results (wave executor; the fused variant is tested
    below)."""
    monkeypatch.setenv("RJT_EXEC_MODE", "shared")
    from radixjoin import engine
    from radixjoin.plan.ir import Plan
    from radixjoin.storage.columnar import sorted_rows

    rng = np.random.default_rng(5)
    n_pk, n_fk = 300, 4000
    pk_rows = [[int(k), int(k) * 7] for k in rng.permutation(n_pk)]
    fk_rows = [[int(k)] for k in rng.integers(0, n_pk, n_fk)]
    dim_rows = [[int(k) * 7, int(k)] for k in range(0, n_pk, 2)]  # dup-free
    t_pk = HostTable.from_rows(pk_rows, [DataType.INT64, DataType.INT64])
    t_fk = HostTable.from_rows(fk_rows, [DataType.INT64])
    t_dim = HostTable.from_rows(dim_rows, [DataType.INT64, DataType.INT64])

    plan = Plan()
    a = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(t_pk)),
                           [(0, DataType.INT64), (1, DataType.INT64)])
    b = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(t_fk)),
                           [(0, DataType.INT64)])
    j1 = plan.new_join_node(True, a, b, 0, 0,
                            [(0, DataType.INT64), (1, DataType.INT64)])
    c = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(t_dim)),
                           [(0, DataType.INT64), (1, DataType.INT64)])
    plan.root = plan.new_join_node(True, c, j1, 0, 1,
                                   [(1, DataType.INT64), (2, DataType.INT64)])

    ctx = engine.build_context()
    r1 = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert hasattr(plan, "_learned_buckets") and plan._learned_buckets
    r2 = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert r2 == r1

    # poison the feedback: absurdly small buckets + flipped flags
    plan._learned_buckets = {
        i: (128, fl) for i, (p, fl) in plan._learned_buckets.items()
    }
    r3 = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert r3 == r1
    plan._learned_buckets = {
        i: (128, not fl) for i, (p, fl) in plan._learned_buckets.items()
    }
    r4 = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert r4 == r1


def test_cardinality_feedback_fused_mode(monkeypatch):
    """Fused mode shares the feedback store: repeat + poisoned learned
    pads (forcing in-program compaction truncation retries) stay exact."""
    monkeypatch.setenv("RJT_EXEC_MODE", "fused")
    from radixjoin import engine
    from radixjoin.plan.ir import Plan
    from radixjoin.storage.columnar import sorted_rows

    rng = np.random.default_rng(9)
    n_pk, n_fk = 200, 3000
    t_pk = HostTable.from_rows(
        [[int(k), int(k) * 3] for k in rng.permutation(n_pk)],
        [DataType.INT64, DataType.INT64])
    t_fk = HostTable.from_rows(
        [[int(k)] for k in rng.integers(0, n_pk, n_fk)], [DataType.INT64])
    t_dim = HostTable.from_rows(
        [[int(k) * 3, int(k)] for k in range(0, n_pk, 3)],
        [DataType.INT64, DataType.INT64])

    plan = Plan()
    a = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(t_pk)),
                           [(0, DataType.INT64), (1, DataType.INT64)])
    b = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(t_fk)),
                           [(0, DataType.INT64)])
    j1 = plan.new_join_node(True, a, b, 0, 0,
                            [(0, DataType.INT64), (1, DataType.INT64)])
    c = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(t_dim)),
                           [(0, DataType.INT64), (1, DataType.INT64)])
    plan.root = plan.new_join_node(True, c, j1, 0, 1,
                                   [(1, DataType.INT64), (2, DataType.INT64)])

    ctx = engine.build_context()
    r1 = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert plan._learned_buckets
    r2 = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert r2 == r1
    plan._learned_buckets = {
        i: (128, fl) for i, (p, fl) in plan._learned_buckets.items()
    }
    r3 = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert r3 == r1
    plan._learned_buckets = {
        i: (128, not fl) for i, (p, fl) in plan._learned_buckets.items()
    }
    r4 = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert r4 == r1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dev_csr_kernel_matches_reference(seed):
    """join_dev_csr_impl (device-built CSR over a key window) produces the
    exact multiset of (build_row, probe_row) pairs — duplicates fan out,
    NULLs never match, out-of-window probe keys miss."""
    import jax.numpy as jnp
    from radixjoin.ops import join as join_ops

    rng = np.random.default_rng(seed)
    nb, npr = 300, 900
    base = 1000
    bk = rng.integers(base, base + 150, nb).astype(np.int64)
    bv = rng.random(nb) > 0.15
    pk = rng.integers(base - 20, base + 260, npr).astype(np.int64)
    pv = rng.random(npr) > 0.15
    bk[0] = bk[1]
    bv[0] = False  # invalid build row carrying a live key

    bpad = join_ops.bucket_size(nb)
    ppad = join_ops.bucket_size(npr)
    kb = join_ops.pad_1d(jnp.asarray(bk), bpad)
    vb = join_ops.pad_1d(jnp.asarray(bv), bpad)
    kp = join_ops.pad_1d(jnp.asarray(pk), ppad)
    vp = join_ops.pad_1d(jnp.asarray(pv), ppad)

    r_pad = join_ops.bucket_size(150)
    expected = ref_join(bk, bv, pk, pv)
    s_pad = join_ops.bucket_size(len(expected))
    bidx, pidx, live, total = join_ops.join_dev_csr_impl(
        kb, vb, kp, vp, jnp.int64(base), r_pad, s_pad
    )
    assert int(total) == len(expected)
    live_np = np.asarray(live)
    got = sorted(zip(
        np.asarray(bidx)[live_np].tolist(), np.asarray(pidx)[live_np].tolist()
    ))
    assert got == expected


def test_fused_dev_csr_path_matches(monkeypatch):
    """A both-children-intermediate join in fused mode takes the dev_csr
    path (RJT_DEV_CSR=force) and stays exact vs the stepwise engine."""
    import jax.numpy as jnp  # noqa: F401
    from radixjoin import engine
    from radixjoin.plan.ir import Plan
    from radixjoin.storage.columnar import (
        ColumnarTable, HostTable, sorted_rows,
    )

    rng = np.random.default_rng(5)
    # four base tables -> two FK->PK-ish joins -> a top join whose BOTH
    # children are intermediates with duplicate keys
    n = 400
    t_a = HostTable.from_rows(
        [[int(k), int(k % 7)] for k in range(60)],
        [DataType.INT64, DataType.INT64],
    )
    rows_b = [[int(rng.integers(0, 60)), int(rng.integers(0, 9))]
              for _ in range(n)]
    t_b = HostTable.from_rows(rows_b, [DataType.INT64, DataType.INT64])
    t_c = HostTable.from_rows(
        [[int(k), int(k % 5)] for k in range(60)],
        [DataType.INT64, DataType.INT64],
    )
    rows_d = [[int(rng.integers(0, 60)), int(rng.integers(0, 9))]
              for _ in range(n)]
    t_d = HostTable.from_rows(rows_d, [DataType.INT64, DataType.INT64])

    def build_plan():
        plan = Plan()
        a = plan.new_scan_node(
            plan.new_input(ColumnarTable.from_host(t_a)),
            [(0, DataType.INT64), (1, DataType.INT64)])
        b = plan.new_scan_node(
            plan.new_input(ColumnarTable.from_host(t_b)),
            [(0, DataType.INT64), (1, DataType.INT64)])
        j1 = plan.new_join_node(True, a, b, 0, 0,
                                [(1, DataType.INT64), (3, DataType.INT64)])
        c = plan.new_scan_node(
            plan.new_input(ColumnarTable.from_host(t_c)),
            [(0, DataType.INT64), (1, DataType.INT64)])
        d = plan.new_scan_node(
            plan.new_input(ColumnarTable.from_host(t_d)),
            [(0, DataType.INT64), (1, DataType.INT64)])
        j2 = plan.new_join_node(True, c, d, 0, 0,
                                [(1, DataType.INT64), (3, DataType.INT64)])
        # both children intermediates, keys = payload mods (duplicates)
        plan.root = plan.new_join_node(
            True, j1, j2, 1, 1,
            [(0, DataType.INT64), (2, DataType.INT64), (3, DataType.INT64)])
        return plan

    ctx = engine.build_context()
    monkeypatch.setenv("RJT_EXEC_MODE", "stepwise")
    expected = sorted_rows(
        engine.execute(build_plan(), ctx).to_host().to_rows())

    monkeypatch.setenv("RJT_EXEC_MODE", "fused")
    monkeypatch.setenv("RJT_DEV_CSR", "force")
    plan = build_plan()
    got = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert got == expected
    from radixjoin.plan import fused as fz
    structure = plan._fused_struct_cache[1]
    strategies = [s.strategy for s in structure.join_specs.values()]
    assert any(s.startswith("dev_csr") for s in strategies), strategies

    # repeat run exercises cardinality feedback over the dev_csr path
    got2 = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert got2 == expected

    monkeypatch.setenv("RJT_DEV_CSR", "off")
    plan3 = build_plan()
    got3 = sorted_rows(engine.execute(plan3, ctx).to_host().to_rows())
    assert got3 == expected
    structure3 = plan3._fused_struct_cache[1]
    assert not any(
        s.strategy.startswith("dev_csr")
        for s in structure3.join_specs.values()
    )


def test_wave_executor_dev_csr_path_matches(monkeypatch):
    """The shape-shared wave executor's both-intermediate joins also take
    the dev_csr path and stay exact vs the stepwise engine."""
    from radixjoin import engine
    from radixjoin.plan import executor as ex
    from radixjoin.plan.ir import Plan
    from radixjoin.storage.columnar import (
        ColumnarTable, HostTable, sorted_rows,
    )

    rng = np.random.default_rng(11)
    t_dim = HostTable.from_rows(
        [[int(k), int(k % 6)] for k in range(80)],
        [DataType.INT64, DataType.INT64])
    t_fact = HostTable.from_rows(
        [[int(rng.integers(0, 80)), int(rng.integers(0, 8))]
         for _ in range(500)],
        [DataType.INT64, DataType.INT64])

    def build_plan():
        plan = Plan()
        a = plan.new_scan_node(
            plan.new_input(ColumnarTable.from_host(t_dim)),
            [(0, DataType.INT64), (1, DataType.INT64)])
        b = plan.new_scan_node(
            plan.new_input(ColumnarTable.from_host(t_fact)),
            [(0, DataType.INT64), (1, DataType.INT64)])
        j1 = plan.new_join_node(True, a, b, 0, 0,
                                [(1, DataType.INT64), (3, DataType.INT64)])
        c = plan.new_scan_node(
            plan.new_input(ColumnarTable.from_host(t_dim)),
            [(0, DataType.INT64), (1, DataType.INT64)])
        d = plan.new_scan_node(
            plan.new_input(ColumnarTable.from_host(t_fact)),
            [(0, DataType.INT64), (1, DataType.INT64)])
        j2 = plan.new_join_node(True, c, d, 0, 0,
                                [(1, DataType.INT64), (3, DataType.INT64)])
        plan.root = plan.new_join_node(
            True, j1, j2, 0, 0,
            [(0, DataType.INT64), (1, DataType.INT64), (3, DataType.INT64)])
        return plan

    ctx = engine.build_context()
    monkeypatch.setenv("RJT_EXEC_MODE", "stepwise")
    expected = sorted_rows(
        engine.execute(build_plan(), ctx).to_host().to_rows())

    monkeypatch.setenv("RJT_EXEC_MODE", "shared")
    monkeypatch.setenv("RJT_DEV_CSR", "force")
    before = ex.path_stats().get("dev_csr", 0) + ex.path_stats().get(
        "dev_csr_swapped", 0)
    got = sorted_rows(engine.execute(build_plan(), ctx).to_host().to_rows())
    assert got == expected
    after = ex.path_stats().get("dev_csr", 0) + ex.path_stats().get(
        "dev_csr_swapped", 0)
    assert after > before, ex.path_stats()

    monkeypatch.setenv("RJT_DEV_CSR", "off")
    got2 = sorted_rows(engine.execute(build_plan(), ctx).to_host().to_rows())
    assert got2 == expected


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_full_sort_carried_matches_reference(seed):
    """join_merge_full_impl (sort-carried payload routing, the r5
    production merge path) produces the exact multiset of projected
    output rows — i32 + i64 payloads, NULL keys, duplicate keys, NULL
    payload values — matching a numpy nested-loop reference."""
    import jax.numpy as jnp
    from radixjoin.ops import join as join_ops

    rng = np.random.default_rng(seed)
    nb, npr = 260, 700
    bk = rng.integers(0, 120, nb).astype(np.int32)
    bv = rng.random(nb) > 0.15
    pk = rng.integers(0, 160, npr).astype(np.int32)
    pv = rng.random(npr) > 0.15
    bpay32 = rng.integers(-(1 << 30), 1 << 30, nb).astype(np.int32)
    bpay_v = rng.random(nb) > 0.2
    ppay64 = rng.integers(-(1 << 60), 1 << 60, npr).astype(np.int64)
    ppay_v = rng.random(npr) > 0.2

    bpad = join_ops.bucket_size(nb)
    ppad = join_ops.bucket_size(npr)
    kb = join_ops.pad_1d(jnp.asarray(bk), bpad)
    vb = join_ops.pad_1d(jnp.asarray(bv), bpad)
    kp = join_ops.pad_1d(jnp.asarray(pk), ppad)
    vp = join_ops.pad_1d(jnp.asarray(pv), ppad)

    expect = []
    for i in range(nb):
        if not bv[i]:
            continue
        for j in range(npr):
            if pv[j] and pk[j] == bk[i]:
                expect.append((
                    int(bpay32[i]) if bpay_v[i] else None,
                    int(ppay64[j]) if ppay_v[j] else None,
                ))
    expect.sort(key=repr)

    out_b, out_p, live, total = join_ops.join_merge_full_impl(
        kb, vb, kp, vp, join_ops.bucket_size(max(len(expect), 1)),
        [(join_ops.pad_1d(jnp.asarray(bpay32), bpad),
          join_ops.pad_1d(jnp.asarray(bpay_v), bpad))],
        [(join_ops.pad_1d(jnp.asarray(ppay64), ppad),
          join_ops.pad_1d(jnp.asarray(ppay_v), ppad))],
    )
    assert int(total) == len(expect)
    lv = np.asarray(live)
    bd, bvv = np.asarray(out_b[0][0]), np.asarray(out_b[0][1])
    pd, pvv = np.asarray(out_p[0][0]), np.asarray(out_p[0][1])
    got = sorted(
        (
            (int(bd[k]) if bvv[k] else None,
             int(pd[k]) if pvv[k] else None)
            for k in range(lv.shape[0]) if lv[k]
        ),
        key=repr,
    )
    assert got == expect


def test_engine_tallies_infra_fallback(monkeypatch):
    """A compile or runtime failure on the device path raises: nothing
    reroutes the query to the host executor, and no degradation is
    tallied for it."""
    from radixjoin import engine
    from radixjoin.dtypes import DataType
    from radixjoin.plan.ir import Plan
    from radixjoin.storage.columnar import ColumnarTable, HostTable

    engine.reset_engine_stats()
    lt = HostTable.from_rows([[1, 10], [2, 20]],
                             [DataType.INT32, DataType.INT64])
    rt = HostTable.from_rows([[2], [3]], [DataType.INT32])
    plan = Plan()
    li = plan.new_input(ColumnarTable.from_host(lt))
    ri = plan.new_input(ColumnarTable.from_host(rt))
    ls = plan.new_scan_node(li, [(0, DataType.INT32), (1, DataType.INT64)])
    rs = plan.new_scan_node(ri, [(0, DataType.INT32)])
    plan.root = plan.new_join_node(
        True, ls, rs, 0, 0, [(1, DataType.INT64), (2, DataType.INT32)]
    )
    plan._name = "unit-infra"
    assert engine.execute(plan, None).num_rows == 1

    for msg in ("INTERNAL: compile failed: subprocess exit code 1",
                "INTERNAL: something is wrong in lowering"):
        def boom(*a, _msg=msg, **k):
            raise RuntimeError(_msg)

        monkeypatch.setattr(engine, "_execute_fused", boom)
        with pytest.raises(RuntimeError, match="INTERNAL"):
            engine.execute(plan, None)
    stats = engine.engine_stats()
    assert not any(v for k, v in stats.items() if k != "queries")
    assert stats["queries"] == {}
    engine.reset_engine_stats()
