"""Device-side page decode (storage/device_decode.py).

The aligned encoder must stay bit-compatible with the standard page
format (any decoder accepts aligned pages), the on-device decode must
round-trip exactly, and the engine's scan path must produce identical
results whether a table arrives as raw aligned pages (device decode), as
greedy reference-layout pages (host-decode fallback), or as a host table
(dense upload). Replaces the host decode of reference
src/build_table.cpp:306-436.
"""

import numpy as np
import pytest

from radixjoin.dtypes import NULL, DataType
from radixjoin.storage import device_decode as dd
from radixjoin.storage import page as pc
from radixjoin.storage.columnar import Column, ColumnarTable, HostTable, sorted_rows

FIXED = [
    (DataType.INT32, np.int32),
    (DataType.INT64, np.int64),
    (DataType.FP64, np.float64),
]


def _column(rng, npdt, n, null_frac=0.25):
    if npdt is np.float64:
        vals = rng.normal(size=n) * 1e6
    else:
        info = np.iinfo(npdt)
        vals = rng.integers(info.min, info.max, n).astype(npdt)
    valid = rng.random(n) >= null_frac
    vals[~valid] = 0
    return vals, valid


@pytest.mark.parametrize("dtype,npdt", FIXED)
@pytest.mark.parametrize("n", [1, 959, 960, 1920, 1921, 4801])
def test_aligned_pages_standard_decodable(dtype, npdt, n):
    rng = np.random.default_rng(n)
    vals, valid = _column(rng, npdt, n)
    pages = dd.encode_fixed_aligned(vals, valid, dtype)
    # every full page holds exactly R rows; the remainder page is standard
    r = dd.ALIGNED_ROWS[dtype]
    assert len(pages) == -(-n // r)
    v2, va2 = pc.decode_fixed(pages, n, dtype)
    np.testing.assert_array_equal(va2, valid)
    np.testing.assert_array_equal(v2[valid], vals[valid])


@pytest.mark.parametrize("dtype,npdt", FIXED)
def test_device_decode_roundtrip(dtype, npdt):
    rng = np.random.default_rng(7)
    n = 2 * dd.ALIGNED_ROWS[dtype] + 123  # 2 full pages + remainder
    vals, valid = _column(rng, npdt, n)
    pages = dd.encode_fixed_aligned(vals, valid, dtype)
    assert dd.aligned_full_pages(pages, n, dtype) == 2
    data, dvalid = dd.decode_fixed_device(pages, n, dtype)
    data, dvalid = np.asarray(data), np.asarray(dvalid)
    np.testing.assert_array_equal(dvalid, valid)
    want = vals.view(np.int64) if npdt is np.float64 else vals
    np.testing.assert_array_equal(data[valid], want[valid])
    assert (data[~valid] == 0).all()  # deterministic fill


def test_greedy_pages_rejected():
    rng = np.random.default_rng(3)
    vals, valid = _column(rng, np.int32, 5000)
    greedy = pc.encode_fixed(vals, valid, DataType.INT32)
    assert dd.aligned_full_pages(greedy, 5000, DataType.INT32) in (None, 0)


def test_all_null_and_all_valid_pages():
    r = dd.ALIGNED_ROWS[DataType.INT64]
    n = 2 * r
    vals = np.arange(n, dtype=np.int64)
    for valid in [np.zeros(n, bool), np.ones(n, bool)]:
        pages = dd.encode_fixed_aligned(vals, valid, DataType.INT64)
        data, dvalid = dd.decode_fixed_device(pages, n, DataType.INT64)
        np.testing.assert_array_equal(np.asarray(dvalid), valid)
        np.testing.assert_array_equal(
            np.asarray(data)[valid], vals[valid]
        )


def _exec_rows(table, num_rows, types):
    """Join the table against itself via the public API and return rows."""
    from radixjoin import Plan, build_context, execute

    plan = Plan()
    ti = plan.new_input(table)
    s = plan.new_scan_node(ti, list(enumerate(types)))
    plan.root = s
    return sorted_rows(execute(plan, build_context()).to_host().to_rows())


def test_engine_scan_paged_vs_host_paths(monkeypatch):
    """The same data through (a) raw aligned pages — device decode, (b)
    RJT_DEVICE_DECODE=off — host-decode fallback, (c) from_host — dense
    upload, must produce identical rows."""
    rng = np.random.default_rng(11)
    n = 4321
    types = [DataType.INT32, DataType.INT64, DataType.FP64]
    cols, host_cols = [], []
    from radixjoin.storage.columnar import HostColumn

    for dtype, npdt in FIXED:
        vals, valid = _column(rng, npdt, n)
        cols.append(Column(dtype, dd.encode_fixed_aligned(vals, valid, dtype)))
        host_cols.append(HostColumn(dtype, vals, valid))
    paged = ColumnarTable(n, cols)  # no _host: device decode is the path
    dense = ColumnarTable.from_host(HostTable(n, host_cols))

    rows_paged = _exec_rows(paged, n, types)
    monkeypatch.setenv("RJT_DEVICE_DECODE", "off")
    rows_off = _exec_rows(
        ColumnarTable(n, [Column(c.type, c.pages.copy()) for c in cols]), n, types
    )
    monkeypatch.delenv("RJT_DEVICE_DECODE")
    rows_dense = _exec_rows(dense, n, types)
    assert rows_paged == rows_off == rows_dense
    assert len(rows_paged) == n


def test_join_over_paged_inputs():
    """An FK join whose inputs arrive as raw aligned pages (the CSV-ingest
    shape) joins exactly: device decode feeds the join kernels."""
    from radixjoin import Plan, build_context, execute

    rng = np.random.default_rng(5)
    nb, npr = 3000, 7000
    bk = rng.permutation(nb * 2)[:nb].astype(np.int64)
    bval = (bk * 3).astype(np.int64)
    pk = rng.integers(0, nb * 2, npr).astype(np.int64)
    bt = ColumnarTable(nb, [
        Column(DataType.INT64, dd.encode_fixed_aligned(bk, np.ones(nb, bool), DataType.INT64)),
        Column(DataType.INT64, dd.encode_fixed_aligned(bval, np.ones(nb, bool), DataType.INT64)),
    ])
    pt = ColumnarTable(npr, [
        Column(DataType.INT64, dd.encode_fixed_aligned(pk, np.ones(npr, bool), DataType.INT64)),
    ])
    plan = Plan()
    bi, pi = plan.new_input(bt), plan.new_input(pt)
    bs = plan.new_scan_node(bi, [(0, DataType.INT64), (1, DataType.INT64)])
    ps = plan.new_scan_node(pi, [(0, DataType.INT64)])
    plan.root = plan.new_join_node(
        True, bs, ps, 0, 0, [(1, DataType.INT64), (2, DataType.INT64)]
    )
    res = execute(plan, build_context())
    expected = int(np.isin(pk, bk).sum())
    assert res.num_rows == expected
    got = res.to_host().to_rows()
    lookup = {int(k): int(v) for k, v in zip(bk, bval)}
    assert all(v == lookup[k] for v, k in got)
