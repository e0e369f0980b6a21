"""Join semantics: the reference's 8 Catch2 cases plus engine-specific edges.

Transliterated behavioral contract from reference tests/unit_tests.cpp:10-282
(plans built with the same builder calls), extended with FP64 key
canonicalization, VARCHAR joins, type-mismatch joins, and multi-join trees.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from radixjoin import (
    ColumnarTable,
    DataType,
    NULL,
    Plan,
    build_context,
    destroy_context,
    execute,
)
from radixjoin.storage.columnar import HostTable, sorted_rows

I32 = DataType.INT32
I64 = DataType.INT64
F64 = DataType.FP64
VC = DataType.VARCHAR


def make_input(rows, types) -> ColumnarTable:
    return ColumnarTable.from_host(HostTable.from_rows(rows, types))


def run(plan: Plan):
    ctx = build_context()
    try:
        result = execute(plan, ctx)
    finally:
        destroy_context(ctx)
    return result


def result_rows(result: ColumnarTable):
    return sorted_rows(result.to_host().to_rows())


def test_empty_join():
    # reference tests/unit_tests.cpp:10-28
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(0, I32)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (1, I32)])
    plan.inputs.append(make_input([], [I32]))
    plan.inputs.append(make_input([], [I32]))
    plan.root = 2
    result = run(plan)
    assert result.num_rows == 0
    assert len(result.columns) == 2
    assert result.columns[0].type == I32
    assert result.columns[1].type == I32


def test_one_line_join():
    # reference tests/unit_tests.cpp:30-57
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(0, I32)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (1, I32)])
    plan.inputs.append(make_input([(1,)], [I32]))
    plan.inputs.append(make_input([(1,)], [I32]))
    plan.root = 2
    result = run(plan)
    assert result.num_rows == 1
    assert result_rows(result) == [(1, 1)]


def test_simple_join():
    # reference tests/unit_tests.cpp:59-91
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(0, I32)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (1, I32)])
    data = [(1,), (2,), (3,)]
    plan.inputs.append(make_input(data, [I32]))
    plan.inputs.append(make_input(data, [I32]))
    plan.root = 2
    result = run(plan)
    assert result.num_rows == 3
    assert result_rows(result) == [(1, 1), (2, 2), (3, 3)]


def test_empty_result():
    # reference tests/unit_tests.cpp:93-123
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(0, I32)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (1, I32)])
    plan.inputs.append(make_input([(1,), (2,), (3,)], [I32]))
    plan.inputs.append(make_input([(4,), (5,), (6,)], [I32]))
    plan.root = 2
    result = run(plan)
    assert result.num_rows == 0
    assert len(result.columns) == 2


def test_multiple_same_keys():
    # reference tests/unit_tests.cpp:125-161
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(0, I32)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (1, I32)])
    data = [(1,), (1,), (2,), (3,)]
    plan.inputs.append(make_input(data, [I32]))
    plan.inputs.append(make_input(data, [I32]))
    plan.root = 2
    result = run(plan)
    assert result.num_rows == 6
    assert result_rows(result) == [(1, 1)] * 4 + [(2, 2), (3, 3)]


def test_null_keys_do_not_match():
    # reference tests/unit_tests.cpp:163-200
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(0, I32)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (1, I32)])
    data = [(1,), (1,), (NULL,), (2,), (3,)]
    plan.inputs.append(make_input(data, [I32]))
    plan.inputs.append(make_input(data, [I32]))
    plan.root = 2
    result = run(plan)
    assert result.num_rows == 6
    assert result_rows(result) == [(1, 1)] * 4 + [(2, 2), (3, 3)]


def test_multiple_columns_projection_reorder():
    # reference tests/unit_tests.cpp:202-241
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(1, VC), (0, I32)])
    plan.new_join_node(True, 0, 1, 0, 1, [(0, I32), (2, I32), (1, VC)])
    data = [
        (1, "xxx"),
        (1, "yyy"),
        (NULL, "zzz"),
        (2, "uuu"),
        (3, "vvv"),
    ]
    plan.inputs.append(make_input(data, [I32, VC]))
    plan.inputs.append(make_input(data, [I32, VC]))
    plan.root = 2
    result = run(plan)
    assert result.num_rows == 6
    assert [c.type for c in result.columns] == [I32, I32, VC]
    assert result_rows(result) == [
        (1, 1, b"xxx"),
        (1, 1, b"xxx"),
        (1, 1, b"yyy"),
        (1, 1, b"yyy"),
        (2, 2, b"uuu"),
        (3, 3, b"vvv"),
    ]


def test_build_on_right():
    # reference tests/unit_tests.cpp:243-282
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(1, VC), (0, I32)])
    plan.new_join_node(False, 0, 1, 0, 1, [(0, I32), (2, I32), (1, VC)])
    data = [
        (1, "xxx"),
        (1, "yyy"),
        (NULL, "zzz"),
        (2, "uuu"),
        (3, "vvv"),
    ]
    plan.inputs.append(make_input(data, [I32, VC]))
    plan.inputs.append(make_input(data, [I32, VC]))
    plan.root = 2
    result = run(plan)
    assert result.num_rows == 6
    assert result_rows(result) == [
        (1, 1, b"xxx"),
        (1, 1, b"xxx"),
        (1, 1, b"yyy"),
        (1, 1, b"yyy"),
        (2, 2, b"uuu"),
        (3, 3, b"vvv"),
    ]


# ---------------------------------------------------------------------------
# Engine-specific extensions beyond the reference suite
# ---------------------------------------------------------------------------


def test_int64_keys():
    plan = Plan()
    plan.new_scan_node(0, [(0, I64)])
    plan.new_scan_node(1, [(0, I64)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I64), (1, I64)])
    big = 2**40
    plan.inputs.append(make_input([(big,), (big + 1,), (NULL,)], [I64]))
    plan.inputs.append(make_input([(big,), (big + 2,), (NULL,)], [I64]))
    plan.root = 2
    assert result_rows(run(plan)) == [(big, big)]


def test_int32_extreme_keys():
    """INT32_MAX keys must not collide with the search sentinel."""
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(0, I32)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (1, I32)])
    hi = 2**31 - 1
    lo = -(2**31)
    plan.inputs.append(make_input([(hi,), (lo,), (NULL,), (0,)], [I32]))
    plan.inputs.append(make_input([(hi,), (lo,), (NULL,), (1,)], [I32]))
    plan.root = 2
    assert result_rows(run(plan)) == [(lo, lo), (hi, hi)]


def test_fp64_keys_zero_and_nan():
    """-0.0 joins +0.0; NaN joins nothing (reference double equality)."""
    plan = Plan()
    plan.new_scan_node(0, [(0, F64)])
    plan.new_scan_node(1, [(0, F64)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, F64), (1, F64)])
    plan.inputs.append(make_input([(0.0,), (float("nan"),), (1.5,)], [F64]))
    plan.inputs.append(make_input([(-0.0,), (float("nan"),), (1.5,)], [F64]))
    plan.root = 2
    rows = result_rows(run(plan))
    assert len(rows) == 2
    assert rows[1] == (1.5, 1.5)
    # 0.0 joined -0.0; both sides keep their original bit patterns
    assert rows[0][0] == 0.0 and rows[0][1] == 0.0
    assert np.signbit(np.float64(rows[0][1]))


def test_varchar_join_keys():
    plan = Plan()
    plan.new_scan_node(0, [(1, VC), (0, I32)])
    plan.new_scan_node(1, [(0, I32), (1, VC)])
    plan.new_join_node(True, 0, 1, 0, 1, [(1, I32), (2, I32), (0, VC)])
    left = [(1, "apple"), (2, "pear"), (3, NULL), (4, "fig")]
    right = [(10, "apple"), (20, "apple"), (30, "plum"), (40, NULL)]
    plan.inputs.append(make_input(left, [I32, VC]))
    plan.inputs.append(make_input(right, [I32, VC]))
    plan.root = 2
    assert result_rows(run(plan)) == [
        (1, 10, b"apple"),
        (1, 20, b"apple"),
    ]


def test_type_mismatch_join_is_empty():
    """INT32 vs INT64 keys: variant-extraction semantics -> empty result
    (reference src/execute.cpp:62-83 extracts by exact alternative type)."""
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(0, I64)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (1, I64)])
    plan.inputs.append(make_input([(1,), (2,)], [I32]))
    plan.inputs.append(make_input([(1,), (2,)], [I64]))
    plan.root = 2
    result = run(plan)
    assert result.num_rows == 0


def test_three_way_join_tree():
    plan = Plan()
    plan.new_scan_node(0, [(0, I32), (1, VC)])  # node 0: (id, name)
    plan.new_scan_node(1, [(0, I32), (1, I32)])  # node 1: (id, fk)
    plan.new_scan_node(2, [(0, I32), (1, VC)])  # node 2: (id, tag)
    # join1 = t0.id == t1.id -> output (t0.name, t1.fk)
    plan.new_join_node(True, 0, 1, 0, 0, [(1, VC), (3, I32)])
    # join2 = join1.fk == t2.id -> output (name, tag)
    plan.new_join_node(False, 3, 2, 1, 0, [(0, VC), (3, VC)])
    plan.inputs.append(make_input([(1, "a"), (2, "b"), (3, "c")], [I32, VC]))
    plan.inputs.append(make_input([(1, 100), (2, 200), (3, 100), (9, 300)], [I32, I32]))
    plan.inputs.append(make_input([(100, "t100"), (200, "t200")], [I32, VC]))
    plan.root = 4
    assert result_rows(run(plan)) == [
        (b"a", b"t100"),
        (b"b", b"t200"),
        (b"c", b"t100"),
    ]


def test_duplicate_heavy_fanout():
    n = 500
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(0, I32)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (1, I32)])
    plan.inputs.append(make_input([(7,)] * n, [I32]))
    plan.inputs.append(make_input([(7,)] * n + [(8,)], [I32]))
    plan.root = 2
    result = run(plan)
    assert result.num_rows == n * n


def test_output_column_duplication():
    """output_attrs may repeat the same child column."""
    plan = Plan()
    plan.new_scan_node(0, [(0, I32)])
    plan.new_scan_node(1, [(0, I32)])
    plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (0, I32), (1, I32)])
    plan.inputs.append(make_input([(5,)], [I32]))
    plan.inputs.append(make_input([(5,)], [I32]))
    plan.root = 2
    assert result_rows(run(plan)) == [(5, 5, 5)]


def test_null_payloads_flow_through():
    plan = Plan()
    plan.new_scan_node(0, [(0, I32), (1, VC)])
    plan.new_scan_node(1, [(0, I32), (1, I64)])
    plan.new_join_node(True, 0, 1, 0, 0, [(1, VC), (3, I64), (0, I32)])
    plan.inputs.append(make_input([(1, NULL), (2, "x")], [I32, VC]))
    plan.inputs.append(make_input([(1, 11), (2, NULL)], [I32, I64]))
    plan.root = 2
    assert result_rows(run(plan)) == [
        (b"x", NULL, 2),
        (NULL, 11, 1),
    ]


def test_scan_only_plan():
    plan = Plan()
    plan.new_scan_node(0, [(1, VC), (0, I32)])
    plan.inputs.append(make_input([(1, "a"), (NULL, "b")], [I32, VC]))
    plan.root = 0
    result = run(plan)
    assert result.num_rows == 2
    assert result_rows(result) == [(b"a", 1), (b"b", NULL)]


def test_malformed_plans_raise_value_error():
    """Malformed plans must fail fast with ValueError at the public
    boundary (Plan.validate), never an internal IndexError."""
    import pytest

    inp = make_input([[1], [2]], [I32])

    p = Plan()
    s = p.new_scan_node(p.new_input(inp.copy()), [(0, I32)])
    p.root = 99
    with pytest.raises(ValueError):
        run(p)

    p = Plan()
    s = p.new_scan_node(p.new_input(inp.copy()), [(0, I32)])
    p.nodes[s].output_attrs = [(7, I32)]  # out-of-range scan column
    p.root = s
    with pytest.raises(ValueError):
        run(p)

    p = Plan()
    s0 = p.new_scan_node(p.new_input(inp.copy()), [(0, I32)])
    s1 = p.new_scan_node(p.new_input(inp.copy()), [(0, I32)])
    j = p.new_join_node(True, s0, s1, 0, 0, [(0, I32)])
    import dataclasses as dc
    p.nodes[j].data = dc.replace(p.nodes[j].data, left_attr=5)  # bad key
    p.root = j
    with pytest.raises(ValueError):
        run(p)


def test_varchar_join_keys_fuse():
    """VARCHAR join keys lower in the fused compiler (unified-dictionary
    device-CSR), not via the wave-executor fallback — duplicates, NULLs,
    and strings private to one side all behave."""
    from radixjoin import engine

    rows_l = [[b"apple", 1], [b"pear", 2], [None, 3], [b"apple", 4],
              [b"quince", 5]]
    rows_r = [[b"apple", 10], [b"plum", 11], [None, 12], [b"pear", 13],
              [b"apple", 14]]
    t_l = HostTable.from_rows(rows_l, [DataType.VARCHAR, DataType.INT64])
    t_r = HostTable.from_rows(rows_r, [DataType.VARCHAR, DataType.INT64])
    plan = Plan()
    s0 = plan.new_scan_node(
        plan.new_input(ColumnarTable.from_host(t_l)),
        [(0, DataType.VARCHAR), (1, DataType.INT64)])
    s1 = plan.new_scan_node(
        plan.new_input(ColumnarTable.from_host(t_r)),
        [(0, DataType.VARCHAR), (1, DataType.INT64)])
    plan.root = plan.new_join_node(
        True, s0, s1, 0, 0,
        [(1, DataType.INT64), (0, DataType.VARCHAR), (3, DataType.INT64)])

    result = engine.execute(plan, engine.build_context())
    got = sorted_rows(result.to_host().to_rows())
    expected = sorted_rows([
        (1, b"apple", 10), (1, b"apple", 14),
        (4, b"apple", 10), (4, b"apple", 14),
        (2, b"pear", 13),
    ])
    assert got == expected
    structure = plan._fused_struct_cache[1]
    assert not structure.has_varchar_key
    strategies = [s.strategy for s in structure.join_specs.values()]
    assert all(s.startswith("dev_csr") for s in strategies), strategies
    # repeat (cardinality feedback over the varchar path)
    got2 = sorted_rows(engine.execute(plan, engine.build_context())
                       .to_host().to_rows())
    assert got2 == expected


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_])
def test_gather_expand_fallback_exact(dtype):
    """The shared-index-stream gather is exact on i32, i64 and bool
    planes at any index order (random, out of any window)."""
    import jax

    from radixjoin.ops import join as join_ops

    rng = np.random.default_rng(4)
    s_len = 50000
    if dtype is np.bool_:
        tabs = [rng.random(s_len) < 0.5 for _ in range(2)]
    else:
        info = np.iinfo(dtype)
        tabs = [rng.integers(info.min, info.max, s_len, dtype=dtype)
                for _ in range(2)]
    pos = rng.integers(0, s_len, 20000).astype(np.int32)
    outs = jax.jit(join_ops.gather_expand_multi)(
        [jnp.asarray(t) for t in tabs], jnp.asarray(pos)
    )
    for t, o in zip(tabs, outs):
        assert np.asarray(o).dtype == t.dtype
        np.testing.assert_array_equal(np.asarray(o), t[pos])
