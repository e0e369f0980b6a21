"""Randomized plan fuzzer: generated join trees vs the row-semantics oracle.

Complements the fixed behavioral cases in tests/test_join_semantics.py
(the reference's 8 Catch2 cases, reference tests/unit_tests.cpp:10-282)
with randomly generated plans that sweep the whole semantic surface at
once: every key dtype, NULL keys and payloads, duplicate/skewed keys,
empty inputs, type-mismatched join keys (never match — reference
src/execute.cpp:62-83), both build sides, multi-join trees, and random
projections with column reordering across sides. Each plan is executed
in every engine mode (fused / shape-shared / stepwise) and distributed
over the 8-device CPU mesh, and the result multiset is compared exactly
against harness.oracle.execute_plan_rows.
"""

import numpy as np
import pytest

from radixjoin import (
    ColumnarTable,
    DataType,
    NULL,
    Plan,
    build_context,
    destroy_context,
    execute,
)
from radixjoin.harness.oracle import (
    execute_plan_numpy,
    execute_plan_rows,
    rows_equal,
    tables_equal,
)
from radixjoin.storage.columnar import HostTable

I32 = DataType.INT32
I64 = DataType.INT64
F64 = DataType.FP64
VC = DataType.VARCHAR
DTYPES = [I32, I64, F64, VC]

# Small vocabularies force duplicate keys (fan-out) and cross-table
# matches; the extremes exercise value-range and long-string paths.
_VOCAB = [b"", b"a", b"abc", b"Movie (2001)", b"\xe9clair", b"x" * 300]
_F64S = [0.0, -0.0, 1.5, -2.25, 3.0, 1e300]


def _gen_value(rng, dt):
    if rng.random() < 0.15:
        return NULL
    r = rng.random()
    if dt is I32:
        return int(rng.integers(-3, 9)) if r < 0.95 else int(2**31 - 1)
    if dt is I64:
        return int(rng.integers(-3, 9)) if r < 0.9 else -(2**62)
    if dt is F64:
        if r < 0.9:
            return float(_F64S[rng.integers(0, len(_F64S))])
        return float("nan")
    return _VOCAB[rng.integers(0, len(_VOCAB))]


def gen_plan(rng) -> Plan:
    """Random binary join tree over 2-4 base tables."""
    plan = Plan()
    table_types = []
    for _ in range(int(rng.integers(2, 5))):
        types = [DTYPES[rng.integers(0, 4)] for _ in range(int(rng.integers(1, 4)))]
        nrows = int(rng.choice([0, 1, 7, 40, 90], p=[0.06, 0.1, 0.3, 0.34, 0.2]))
        rows = [tuple(_gen_value(rng, t) for t in types) for _ in range(nrows)]
        plan.new_input(ColumnarTable.from_host(HostTable.from_rows(rows, types)))
        table_types.append(types)

    nodes = []  # (node_id, output dtypes)
    for tid, types in enumerate(table_types):
        sel = rng.permutation(len(types))[: int(rng.integers(1, len(types) + 1))]
        attrs = [(int(c), types[int(c)]) for c in sel]
        nodes.append((plan.new_scan_node(tid, attrs), [t for _, t in attrs]))

    while len(nodes) > 1:
        i, j = (int(x) for x in rng.choice(len(nodes), 2, replace=False))
        (ln, lt), (rn, rt) = nodes[i], nodes[j]
        matched = [
            (a, b) for a in range(len(lt)) for b in range(len(rt)) if lt[a] is rt[b]
        ]
        if matched and rng.random() > 0.07:
            la, ra = matched[rng.integers(0, len(matched))]
        else:  # mismatched key dtypes: join must be statically empty
            la = int(rng.integers(0, len(lt)))
            ra = int(rng.integers(0, len(rt)))
        combined = lt + rt
        sel = rng.permutation(len(combined))[
            : int(rng.integers(1, min(len(combined), 5) + 1))
        ]
        attrs = [(int(c), combined[int(c)]) for c in sel]
        nid = plan.new_join_node(
            bool(rng.random() < 0.5), ln, rn, la, ra, attrs
        )
        nodes = [nodes[k] for k in range(len(nodes)) if k not in (i, j)]
        nodes.append((nid, [t for _, t in attrs]))

    plan.root = nodes[0][0]
    plan.validate()
    return plan


def _mask_nan(rows):
    # NaN != NaN breaks Counter-based multiset comparison; NaN payload
    # values are legal in outputs, so map them to a marker byte-string.
    return [
        tuple(
            b"\x00NaN" if isinstance(v, float) and v != v else v for v in r
        )
        for r in rows
    ]


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_all_engine_modes(seed, monkeypatch):
    rng = np.random.default_rng(1000 + seed)
    plan = gen_plan(rng)
    expected = _mask_nan(execute_plan_rows(plan))
    for mode in ("auto", "shared", "stepwise"):
        monkeypatch.setenv("RJT_EXEC_MODE", mode)
        ctx = build_context()
        try:
            actual = _mask_nan(execute(plan, ctx).to_host().to_rows())
        finally:
            destroy_context(ctx)
        ok, msg = rows_equal(actual, expected)
        assert ok, f"seed {seed} mode {mode}: {msg}"


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_high_fanout_with_feedback(seed):
    # Few distinct keys on both sides -> output rows >> input rows,
    # exercising exact-totals overflow retry, compaction pads, and (on
    # the repeat run) cardinality feedback + the learned root window.
    rng = np.random.default_rng(4000 + seed)
    n1, n2 = int(rng.integers(500, 2000)), int(rng.integers(500, 2000))
    dom = int(rng.integers(3, 12))
    r1 = [(int(k), i) for i, k in enumerate(rng.integers(0, dom, n1))]
    r2 = [(int(k), i * 2) for i, k in enumerate(rng.integers(0, dom, n2))]
    plan = Plan()
    plan.new_scan_node(0, [(0, I32), (1, I64)])
    plan.new_scan_node(1, [(0, I32), (1, I64)])
    plan.new_join_node(
        bool(rng.random() < 0.5), 0, 1, 0, 0, [(1, I64), (3, I64), (0, I32)]
    )
    for rows in (r1, r2):
        plan.inputs.append(
            ColumnarTable.from_host(HostTable.from_rows(rows, [I32, I64]))
        )
    plan.root = 2
    expected = execute_plan_rows(plan)
    ctx = build_context()
    try:
        first = execute(plan, ctx).to_host().to_rows()
        repeat = execute(plan, ctx).to_host().to_rows()
    finally:
        destroy_context(ctx)
    for tag, actual in (("first", first), ("repeat", repeat)):
        ok, msg = rows_equal(actual, expected)
        assert ok, f"seed {seed} {tag}: {msg}"


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_spill_executor(seed, monkeypatch):
    # A tiny HBM budget forces every plan through the out-of-HBM
    # host-staged multi-pass radix executor (engine._execute_host_partitioned).
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", "4096")
    rng = np.random.default_rng(3000 + seed)
    plan = gen_plan(rng)
    expected = _mask_nan(execute_plan_rows(plan))
    ctx = build_context()
    try:
        actual = _mask_nan(execute(plan, ctx).to_host().to_rows())
    finally:
        destroy_context(ctx)
    ok, msg = rows_equal(actual, expected)
    assert ok, f"seed {seed} spill: {msg}"


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_distributed(seed):
    from radixjoin.parallel.dist_executor import execute_distributed

    rng = np.random.default_rng(2000 + seed)
    plan = gen_plan(rng)
    expected = _mask_nan(execute_plan_rows(plan))
    actual = _mask_nan(execute_distributed(plan).to_rows())
    ok, msg = rows_equal(actual, expected)
    assert ok, f"seed {seed} distributed: {msg}"


def test_fuzz_execute_many_batch():
    # One batch of generated plans through the throughput API: mixed
    # dtypes and sizes, some falling back (VARCHAR keys / tiny inputs),
    # all compared to the oracle in one execute_many call.
    from radixjoin import execute_many

    plans = [gen_plan(np.random.default_rng(5000 + s)) for s in range(6)]
    expected = [_mask_nan(execute_plan_rows(p)) for p in plans]
    ctx = build_context()
    try:
        results = execute_many(plans, ctx)
    finally:
        destroy_context(ctx)
    for s, (exp, res) in enumerate(zip(expected, results)):
        ok, msg = rows_equal(_mask_nan(res.to_host().to_rows()), exp)
        assert ok, f"batch plan {s}: {msg}"


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_numpy_reference(seed):
    # The vectorized numpy reference must agree with the row interpreter
    # on every generated plan (NULL/NaN/-0.0 keys, VARCHAR keys, type
    # mismatches, empty inputs), and the column-wise comparison must
    # agree with the row-wise one on the engine's result.
    rng = np.random.default_rng(6000 + seed)
    plan = gen_plan(rng)
    reference = execute_plan_numpy(plan)
    ok, msg = rows_equal(
        _mask_nan(reference.to_rows()), _mask_nan(execute_plan_rows(plan))
    )
    assert ok, f"seed {seed} numpy reference: {msg}"
    ctx = build_context()
    try:
        actual = execute(plan, ctx).to_host()
    finally:
        destroy_context(ctx)
    ok, msg = tables_equal(actual, reference)
    assert ok, f"seed {seed} engine vs numpy reference: {msg}"
