"""Distributed shuffle join on a virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from radixjoin.parallel import DistJoinConfig, distributed_join, make_mesh
from radixjoin.parallel.dist_join import collect_to_host


def reference_join(bk, bv, bp, pk, pv, pp):
    """Independent numpy nested-hash join for comparison."""
    index = {}
    for i in range(len(bk)):
        if bv[i]:
            index.setdefault(int(bk[i]), []).append(i)
    rows = []
    for j in range(len(pk)):
        if not pv[j]:
            continue
        for i in index.get(int(pk[j]), ()):
            rows.append(
                (int(bk[i]),)
                + tuple(int(v[i]) for v in bp.values())
                + tuple(int(v[j]) for v in pp.values())
            )
    return sorted(rows)


def run_and_compare(bk, bv, bp, pk, pv, pp, mesh, config=None):
    columns, live, totals = distributed_join(
        bk, bv, bp, pk, pv, pp, mesh=mesh, config=config
    )
    out = collect_to_host(columns, live)
    names = (
        ["__build_key"]
        + [f"b.{k}" for k in bp]
        + [f"p.{k}" for k in pp]
    )
    got = sorted(zip(*[out[n].tolist() for n in names]))
    expected = reference_join(bk, bv, bp, pk, pv, pp)
    assert got == expected
    return int(np.asarray(live).sum())


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def test_distributed_join_basic(mesh):
    rng = np.random.default_rng(0)
    nb, np_ = 2000, 5000
    bk = rng.integers(0, 1500, nb).astype(np.int64)
    bv = rng.random(nb) > 0.05
    pk = rng.integers(0, 3000, np_).astype(np.int64)
    pv = rng.random(np_) > 0.05
    bp = {"payload": rng.integers(0, 100, nb).astype(np.int32)}
    pp = {"rowid": np.arange(np_, dtype=np.int32)}
    total = run_and_compare(bk, bv, bp, pk, pv, pp, mesh)
    assert total > 0


def test_distributed_join_empty_sides(mesh):
    bk = np.zeros(0, dtype=np.int64)
    bv = np.zeros(0, dtype=bool)
    pk = np.arange(100, dtype=np.int64)
    pv = np.ones(100, dtype=bool)
    total = run_and_compare(bk, bv, {}, pk, pv, {"r": pk.astype(np.int32)}, mesh)
    assert total == 0


def test_distributed_join_skewed_hot_key(mesh):
    """One key carries 60% of the probe side — must route via the broadcast
    path (or survive a capacity retry) and stay exact."""
    rng = np.random.default_rng(1)
    nb, np_ = 500, 20000
    bk = np.arange(nb).astype(np.int64)
    bv = np.ones(nb, dtype=bool)
    pk = rng.integers(0, nb, np_).astype(np.int64)
    hot = rng.random(np_) < 0.6
    pk[hot] = 7
    pv = np.ones(np_, dtype=bool)
    bp = {"b": (bk * 10).astype(np.int64)}
    pp = {"p": np.arange(np_, dtype=np.int64)}
    total = run_and_compare(bk, bv, bp, pk, pv, pp, mesh)
    assert total >= int(hot.sum())


def test_distributed_join_duplicate_build_keys(mesh):
    bk = np.array([5, 5, 5, 9], dtype=np.int64)
    bv = np.ones(4, dtype=bool)
    pk = np.array([5, 9, 9, 11], dtype=np.int64)
    pv = np.ones(4, dtype=bool)
    total = run_and_compare(
        bk, bv, {"b": np.arange(4, dtype=np.int32)},
        pk, pv, {"p": np.arange(4, dtype=np.int32)}, mesh
    )
    assert total == 5


def test_distributed_join_skewed_build_side(mesh):
    """An all-one-key BUILD side overflows both the radix shuffle (every
    row hashes to one owner device) and the hot-broadcast buffer, and
    probe-side hot-key sampling cannot predict it — the capacity ladder
    must grow every receive buffer until the worst case is covered
    (regression: fuzz seed 20048 raised 'overflow persisted')."""
    rng = np.random.default_rng(7)
    nb, np_ = 400, 300
    bk = np.full(nb, 7, dtype=np.int64)  # every build row shares one key
    bv = np.ones(nb, dtype=bool)
    pk = np.where(rng.random(np_) < 0.5, 7, rng.integers(100, 200, np_))
    pk = pk.astype(np.int64)
    pv = np.ones(np_, dtype=bool)
    bp = {"x": np.arange(nb, dtype=np.int64)}
    pp = {"y": np.arange(np_, dtype=np.int64)}
    run_and_compare(bk, bv, bp, pk, pv, pp, mesh)


def test_distributed_join_bloom_semijoin(mesh):
    """~99.9% of probe keys miss every build key — the build-side Bloom
    pre-filter must drop them before the all_to_all without losing any
    true match.  Exercised at the minimum filter size (high
    false-positive rate, stresses the no-false-negative property) and
    with the filter disabled; both must be exact."""
    rng = np.random.default_rng(11)
    nb, np_ = 300, 10000
    bk = rng.integers(0, 400, nb).astype(np.int64)
    bv = np.ones(nb, dtype=bool)
    pk = rng.integers(0, 1_000_000, np_).astype(np.int64)
    pk[:17] = bk[:17]  # guarantee some true matches survive
    pv = np.ones(np_, dtype=bool)
    pp = {"p": np.arange(np_, dtype=np.int64)}
    for cfg in (
        DistJoinConfig(bloom_max_bits=8192),
        DistJoinConfig(bloom_max_bits=0),
    ):
        total = run_and_compare(bk, bv, {}, pk, pv, pp, mesh, cfg)
        assert total >= 17


def test_distributed_join_chunked_exchange(mesh):
    """exchange_chunks>1 splits the key space into independently exchanged
    sub-partitions (the overlap-ready double-buffered layout); results
    must be identical to the monolithic exchange, including with a heavy
    hitter routed through the hot-broadcast group and with the Bloom
    filter on or off."""
    rng = np.random.default_rng(5)
    nb, np_ = 3000, 12000
    bk = rng.integers(0, 900, nb).astype(np.int64)
    bv = rng.random(nb) > 0.1
    pk = rng.integers(0, 1800, np_).astype(np.int64)
    pk[: np_ // 3] = 42  # heavy hitter -> hot group alongside the chunks
    pv = rng.random(np_) > 0.1
    bp = {"b": rng.integers(0, 1000, nb).astype(np.int64)}
    pp = {"p": np.arange(np_, dtype=np.int64)}
    for cfg in (
        DistJoinConfig(exchange_chunks=3),
        DistJoinConfig(exchange_chunks=4, bloom_max_bits=0),
    ):
        run_and_compare(bk, bv, bp, pk, pv, pp, mesh, cfg)


def test_distributed_matches_hot_and_cold_disjoint(mesh):
    """Hot-path rows and cold-path rows must not double-count."""
    rng = np.random.default_rng(3)
    nb, np_ = 1000, 8000
    bk = rng.integers(0, 200, nb).astype(np.int64)  # many duplicate build keys
    bv = np.ones(nb, dtype=bool)
    pk = rng.integers(0, 200, np_).astype(np.int64)
    pk[: np_ // 2] = 13  # heavy hitter with many build duplicates
    pv = np.ones(np_, dtype=bool)
    config = DistJoinConfig(max_hot_keys=4)
    run_and_compare(bk, bv, {}, pk, pv, {"p": np.arange(np_, dtype=np.int64)}, mesh, config)


# ---------------------------------------------------------------------------
# Whole-plan distributed execution (parallel/dist_executor.py): full JOB
# plans on the 8-device mesh, intermediates never leave the mesh, results
# exact vs the row-semantics oracle.
# ---------------------------------------------------------------------------

import pytest

from radixjoin.harness import datagen, oracle
from radixjoin.harness.run import (
    DEFAULT_PLANS, JobHarness, TableSource, load_workload,
)
from radixjoin.parallel.dist_executor import execute_distributed


@pytest.fixture(scope="module")
def job_harness():
    _, _, queries = load_workload()
    gen = datagen.SyntheticIMDB(scale=0.0004, seed=7, queries=queries)
    tables = gen.generate()
    return JobHarness(DEFAULT_PLANS, TableSource(host_tables=tables))


# short plans keep the per-join shard_map compile bill affordable on the
# virtual CPU mesh; s8 exercises duplicate-heavy joins, s3 an IN list
# over movie_info, s1 the canonical 4-join chain
@pytest.mark.parametrize("name", ["s1", "s3", "s8"])
def test_distributed_full_plan_job(job_harness, name):
    _, plan = job_harness.build_plan(name)
    result = execute_distributed(plan)
    actual = result.to_rows()
    expected = oracle.execute_plan_rows(plan)
    correct, detail = oracle.rows_equal(actual, expected)
    assert correct, f"{name}: {detail}"


def test_distributed_feedback_warm_replay(job_harness):
    """A repeat execution of the same plan shape replays every join
    sync-free from the learned feedback (capacities, hot keys, output
    buckets) with one batched validation at the root — and must return
    the identical result."""
    from radixjoin.parallel import dist_executor

    _, plan = job_harness.build_plan("s3")
    first = execute_distributed(plan).to_rows()
    key = dist_executor._plan_key(plan)
    assert any(k[0] == key for k in dist_executor._DIST_FEEDBACK), \
        "cold run must learn feedback"
    _, plan2 = job_harness.build_plan("s3")  # fresh Plan, same content key
    assert dist_executor._plan_key(plan2) == key
    second = execute_distributed(plan2).to_rows()
    ok, detail = oracle.rows_equal(second, first)
    assert ok, detail


def test_distributed_feedback_stale_detection(mesh):
    """Same plan shape + row counts but DIFFERENT data: the warm replay's
    learned totals cannot match, the root check must fail, and the cold
    rerun must still be exact."""
    from radixjoin.dtypes import DataType
    from radixjoin.harness import oracle as orc
    from radixjoin.parallel import dist_executor
    from radixjoin.plan.ir import Plan
    from radixjoin.storage.columnar import ColumnarTable, HostTable

    def make(bkeys, pkeys):
        plan = Plan()
        tb = plan.new_input(ColumnarTable.from_host(HostTable.from_rows(
            [[int(k), i] for i, k in enumerate(bkeys)],
            [DataType.INT64, DataType.INT64])))
        tp = plan.new_input(ColumnarTable.from_host(HostTable.from_rows(
            [[int(k), i * 10] for i, k in enumerate(pkeys)],
            [DataType.INT64, DataType.INT64])))
        sb = plan.new_scan_node(tb, [(0, DataType.INT64), (1, DataType.INT64)])
        sp = plan.new_scan_node(tp, [(0, DataType.INT64), (1, DataType.INT64)])
        plan.root = plan.new_join_node(
            True, sb, sp, 0, 0,
            [(1, DataType.INT64), (3, DataType.INT64)])
        return plan

    rng = np.random.default_rng(9)
    n = 600
    p1 = make(rng.integers(0, 50, n), rng.integers(0, 50, n))
    r1 = execute_distributed(p1, mesh=mesh)
    ok, detail = orc.rows_equal(r1.to_rows(), orc.execute_plan_rows(p1))
    assert ok, detail
    base = dist_executor._fb_base_key(p1, mesh, DistJoinConfig())
    assert base + (p1.root,) in dist_executor._DIST_FEEDBACK
    learned_1 = dist_executor._DIST_FEEDBACK[base + (p1.root,)]["totals"]

    # identical shape, totally different join cardinalities
    p2 = make(rng.integers(100, 105, n), rng.integers(100, 105, n))
    assert dist_executor._fb_base_key(p2, mesh, DistJoinConfig()) == base
    r2 = execute_distributed(p2, mesh=mesh)
    ok, detail = orc.rows_equal(r2.to_rows(), orc.execute_plan_rows(p2))
    assert ok, detail
    # the mismatch evicted the stale entries and the cold rerun re-learned
    learned_2 = dist_executor._DIST_FEEDBACK[base + (p2.root,)]["totals"]
    assert not np.array_equal(learned_1, learned_2)


def test_distributed_plan_empty_and_mismatch(mesh):
    """Type-mismatch joins and empty children are empty, like the
    single-chip engine (src/execute.cpp:50, :75-83)."""
    from radixjoin.dtypes import DataType
    from radixjoin.plan.ir import Plan
    from radixjoin.storage.columnar import ColumnarTable, HostTable

    plan = Plan()
    t0 = plan.new_input(ColumnarTable.from_host(HostTable.from_rows(
        [[1, 10], [2, 20]], [DataType.INT32, DataType.INT64])))
    t1 = plan.new_input(ColumnarTable.from_host(HostTable.from_rows(
        [[10, 1]], [DataType.INT64, DataType.INT32])))
    s0 = plan.new_scan_node(t0, [(0, DataType.INT32), (1, DataType.INT64)])
    s1 = plan.new_scan_node(t1, [(1, DataType.INT32)])
    # INT32 vs INT64 key mismatch -> statically empty
    plan.root = plan.new_join_node(
        True, s0, s1, 1, 0, [(0, DataType.INT32), (2, DataType.INT32)]
    )
    out = execute_distributed(plan, mesh=mesh)
    assert out.num_rows == 0
