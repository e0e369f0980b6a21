"""Device-memory ledger: deterministic accounting + eviction (VERDICT r2 #1).

Round 2's sf1.0 suite OOM'd because cross-query pinned caches accumulated
past HBM and the retry ladder raced the runtime's async deallocation. The
ledger replaces that with bookkeeping: every cache upload charges exact
bytes, queries reserve their estimated working set before dispatching, and
idle LRU entries are explicitly evicted (``.delete()``) to fit the budget.
These tests drive real plans through artificially tiny budgets and check
(a) results stay exact, (b) evictions actually fire, (c) concurrent
admission control neither deadlocks nor corrupts results.
"""

import threading

import pytest

from radixjoin import engine
from radixjoin.engine import DeviceLedger, device_ledger
from radixjoin.harness import datagen, oracle
from radixjoin.harness.run import (
    DEFAULT_PLANS, JobHarness, TableSource, load_workload,
)

QUERIES = ["s1", "s2", "s3", "s5", "s8", "s10"]


@pytest.fixture(scope="module")
def setup():
    _, _, queries = load_workload()
    gen = datagen.SyntheticIMDB(scale=0.0004, seed=7, queries=queries)
    tables = gen.generate()
    source = TableSource(host_tables=tables)
    harness = JobHarness(DEFAULT_PLANS, source)
    return harness, oracle.SqliteOracle(tables)


# ---------------------------------------------------------------------------
# Ledger mechanics (no device involved)
# ---------------------------------------------------------------------------


class _Owner:
    def __init__(self):
        self.released = False


def test_ledger_lru_eviction_order():
    led = DeviceLedger()
    owners = [_Owner() for _ in range(3)]

    def release(o):
        o.released = True

    for o in owners:
        led.charge(o, 100, release)
    led.touch(owners[0])  # owners[1] is now least recently used
    # budget 250: need to free >= 50 of the 300 pinned -> evict exactly
    # the LRU entry (owners[1])
    with led.reserve(0, 250):
        pass
    assert owners[1].released and not owners[0].released
    assert not owners[2].released
    assert led.pinned_bytes() == 200
    assert led.stats["evictions"] == 1


def test_ledger_active_entries_never_evicted():
    led = DeviceLedger()
    hot, cold = _Owner(), _Owner()

    def release(o):
        o.released = True

    with led.reserve(100, 1000):
        led.charge(hot, 400, release)  # touched by the active query
    led.charge(cold, 400, release)
    # over budget with an idle entry available: evict cold, never hot...
    # but hot's query has ENDED, so both are now evictable; LRU = hot
    with led.reserve(300, 1000):
        pass
    assert hot.released  # LRU after its query ended
    assert not cold.released


def test_ledger_inflight_protection():
    led = DeviceLedger()
    mine = _Owner()

    def release(o):
        o.released = True

    res = led.reserve(100, 1000)
    with led.activate(res.token):
        led.charge(mine, 900, release)
    # another (non-blocking) reservation cannot evict an in-flight
    # query's entries and must be refused
    assert led.reserve(500, 1000, block=False) is None
    assert not mine.released
    res.close()
    # after release the entry is idle and evictable
    assert led.reserve(500, 1000, block=False) is not None
    assert mine.released


def test_ledger_weakref_cleanup():
    led = DeviceLedger()
    o = _Owner()
    led.charge(o, 123, lambda _o: None)
    assert led.pinned_bytes() == 123
    del o
    import gc

    gc.collect()
    assert led.pinned_bytes() == 0


# ---------------------------------------------------------------------------
# Real plans under tiny budgets
# ---------------------------------------------------------------------------


def _run_all(harness, names, sqlite_oracle):
    for name in names:
        _result, _ms, correct, detail = harness.run_query(
            name, verify=True, sqlite_oracle=sqlite_oracle
        )
        assert correct, f"{name}: {detail}"


def test_eviction_under_tiny_budget(setup, monkeypatch):
    """A budget sized to hold ~one query's working set forces evictions
    between queries; results must stay exact and evictions must fire."""
    harness, sqlite_oracle = setup
    # budget: holds any ONE query's working set but not the whole suite's
    # cumulative pinned caches
    budget = max(
        engine._estimate_query_bytes(harness.build_plan(n)[1])
        for n in QUERIES
    ) + (64 << 10)
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(budget))
    before = device_ledger().stats["evictions"]
    _run_all(harness, QUERIES, sqlite_oracle)
    _run_all(harness, QUERIES, sqlite_oracle)  # re-uploads after eviction
    assert device_ledger().stats["evictions"] > before


def test_concurrent_admission_control(setup, monkeypatch):
    """The bench warmup shape: many threads executing concurrently under
    a budget that cannot hold them all at once. Admission control must
    serialize the overflow without deadlock, results stay exact."""
    harness, sqlite_oracle = setup
    plans = {n: harness.build_plan(n)[1] for n in QUERIES}
    expect = {n: engine.execute(p, harness.context) for n, p in plans.items()}
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(
        max(engine._estimate_query_bytes(p) for p in plans.values())
        + (64 << 10)
    ))
    errors, got = [], {}

    def worker(name):
        try:
            got[name] = engine.execute(plans[name], harness.context)
        except Exception as e:  # noqa: BLE001
            errors.append((name, e))

    threads = [threading.Thread(target=worker, args=(n,)) for n in QUERIES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "admission control deadlocked"
    assert not errors, errors
    for name in QUERIES:  # verify on the main thread (sqlite thread-bound)
        ok, msg = oracle.rows_equal(
            got[name].to_host().to_rows(), expect[name].to_host().to_rows()
        )
        assert ok, f"{name}: {msg}"


def test_execute_many_admission(setup, monkeypatch):
    """Batch mode under a tiny budget defers over-budget plans instead of
    dispatching everything at once (the round-2 sf1.0 batch-stage OOM)."""
    harness, sqlite_oracle = setup
    plans = [harness.build_plan(n)[1] for n in QUERIES]
    expect = [engine.execute(p, harness.context) for p in plans]
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(4 << 20))
    got = engine.execute_many(plans, harness.context)
    for name, e, g in zip(QUERIES, expect, got):
        he, hg = e.to_host(), g.to_host()
        assert he.num_rows == hg.num_rows, name
        ok, msg = oracle.rows_equal(he.to_rows(), hg.to_rows())
        assert ok, f"{name}: {msg}"


def test_precompile_then_concurrent_execute_eviction(setup, monkeypatch):
    """r3 #1a regression — the r6 sf1.0 crash shape. Phase-0
    ``precompile_fused`` populates each plan's ``_fused_struct_cache``
    with live device refs OUTSIDE any active reservation token; a
    concurrent execute pool under a one-query budget then churns
    evictions, which delete those refs. The r6 run dispatched a stale
    struct and died with ``RuntimeError: Array has been deleted``
    (/tmp/bench_sf1_r6.log, engine.py:887); the fix path is
    ``FusedPlan.revalidate`` + the pin-first memo protocol — this test
    must finish with zero errors and exact rows."""
    import concurrent.futures as cf

    harness, sqlite_oracle = setup
    plans = {n: harness.build_plan(n)[1] for n in QUERIES}
    expect = {n: engine.execute(p, harness.context) for n, p in plans.items()}
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(
        max(engine._estimate_query_bytes(p) for p in plans.values())
        + (64 << 10)
    ))
    # phase 0: wide precompile pool (the bench's 24-thread shape)
    with cf.ThreadPoolExecutor(8) as ex:
        list(ex.map(
            lambda p: engine.precompile_fused(p, harness.context),
            plans.values(),
        ))
    errors, got = [], {}

    def worker(name):
        try:
            for _ in range(3):  # repeat: struct-cache hits under churn
                got[name] = engine.execute(plans[name], harness.context)
        except Exception as e:  # noqa: BLE001
            errors.append((name, repr(e)))

    threads = [threading.Thread(target=worker, args=(n,)) for n in QUERIES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        assert not t.is_alive(), "admission control deadlocked"
    assert not errors, errors
    assert device_ledger().stats["evictions"] > 0
    for name in QUERIES:
        ok, msg = oracle.rows_equal(
            got[name].to_host().to_rows(), expect[name].to_host().to_rows()
        )
        assert ok, f"{name}: {msg}"


def test_ledger_touch_reports_eviction():
    """touch() must return False once the entry is gone — a True return
    is the token-protection contract revalidate/memo hits rely on."""
    led = DeviceLedger()
    o = _Owner()
    led.charge(o, 100, lambda _o: None)
    assert led.touch(o) is True
    with led.reserve(0, 50):  # forces eviction of the idle entry
        pass
    assert led.touch(o) is False


def test_estimator_includes_join_intermediates(setup):
    """r2 verdict #1: the estimate must exceed scan bytes (join output
    buffers + sort transients are the part round 2 missed)."""
    harness, _ = setup
    plan = harness.build_plan("s8")[1]
    scans = engine._estimate_scan_bytes(plan)
    est = engine._estimate_query_bytes(plan)
    assert est > scans
