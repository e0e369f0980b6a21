"""Page codec round-trip tests.

Covers the behaviors the reference decoder handles
(src/build_table.cpp:312-436): NULL bitmaps at the page tail, dense non-null
value packing, VARCHAR end-offset pages, long-string 0xffff/0xfffe page
chains, and multi-page spill.
"""

import numpy as np
import pytest

from radixjoin.dtypes import DataType, PAGE_SIZE
from radixjoin.storage import page as pc
from radixjoin.storage.columnar import ColumnarTable, HostTable
from radixjoin.dtypes import NULL


def roundtrip_fixed(values, valid, dtype):
    pages = pc.encode_fixed(np.asarray(values, dtype.numpy_dtype), np.asarray(valid), dtype)
    out_vals, out_valid = pc.decode_fixed(pages, len(valid), dtype)
    return pages, out_vals, out_valid


@pytest.mark.parametrize("dtype", [DataType.INT32, DataType.INT64, DataType.FP64])
def test_fixed_roundtrip_small(dtype):
    values = [1, 2, 3, 0, 5]
    valid = [True, True, True, False, True]
    _, out_vals, out_valid = roundtrip_fixed(values, valid, dtype)
    assert out_valid.tolist() == valid
    np.testing.assert_array_equal(out_vals[out_valid], np.asarray(values, dtype.numpy_dtype)[np.asarray(valid)])


@pytest.mark.parametrize("dtype", [DataType.INT32, DataType.INT64, DataType.FP64])
def test_fixed_roundtrip_multipage(dtype):
    rng = np.random.default_rng(0)
    n = 50_000
    values = rng.integers(-(2**31), 2**31 - 1, n).astype(dtype.numpy_dtype)
    valid = rng.random(n) > 0.3
    pages, out_vals, out_valid = roundtrip_fixed(values, valid, dtype)
    assert pages.shape[0] > 1
    np.testing.assert_array_equal(out_valid, valid)
    np.testing.assert_array_equal(out_vals[valid], values[valid])


def test_fixed_all_null():
    n = 10_000
    values = np.zeros(n, dtype=np.int32)
    valid = np.zeros(n, dtype=bool)
    pages, out_vals, out_valid = roundtrip_fixed(values, valid, DataType.INT32)
    assert not out_valid.any()


def test_fixed_empty():
    pages = pc.encode_fixed(np.zeros(0, np.int32), np.zeros(0, bool), DataType.INT32)
    assert pages.shape == (0, PAGE_SIZE)
    vals, valid = pc.decode_fixed(pages, 0, DataType.INT32)
    assert len(vals) == 0


def test_fp64_bit_exactness():
    values = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-308], dtype=np.float64)
    valid = np.ones(len(values), dtype=bool)
    _, out_vals, out_valid = roundtrip_fixed(values, valid, DataType.FP64)
    np.testing.assert_array_equal(out_vals.view(np.int64), values.view(np.int64))


def _obj(values):
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


def test_varchar_roundtrip_small():
    values = _obj([b"xxx", b"", b"hello world", b"", b"a"])
    valid = np.array([True, False, True, False, True])
    pages = pc.encode_varchar(values, valid)
    out_vals, out_valid = pc.decode_varchar(pages, 5)
    np.testing.assert_array_equal(out_valid, valid)
    assert [out_vals[i] for i in np.nonzero(valid)[0]] == [b"xxx", b"hello world", b"a"]


def test_varchar_empty_string_vs_null():
    values = _obj([b"", b""])
    valid = np.array([True, False])
    pages = pc.encode_varchar(values, valid)
    out_vals, out_valid = pc.decode_varchar(pages, 2)
    assert out_valid.tolist() == [True, False]
    assert out_vals[0] == b""


def test_varchar_multipage():
    rng = np.random.default_rng(1)
    n = 20_000
    lens = rng.integers(0, 40, n)
    values = _obj([bytes(rng.integers(65, 91, l).astype(np.uint8)) for l in lens])
    valid = rng.random(n) > 0.2
    pages = pc.encode_varchar(values, valid)
    assert pages.shape[0] > 1
    out_vals, out_valid = pc.decode_varchar(pages, n)
    np.testing.assert_array_equal(out_valid, valid)
    for i in np.nonzero(valid)[0]:
        assert out_vals[i] == values[i]


def test_varchar_long_strings():
    long1 = b"A" * (PAGE_SIZE - 6)  # just over the inline limit
    long2 = b"B" * (3 * PAGE_SIZE)  # spans multiple continuation pages
    values = _obj([b"pre", long1, b"mid", long2, b"post"])
    valid = np.ones(5, dtype=bool)
    pages = pc.encode_varchar(values, valid)
    out_vals, out_valid = pc.decode_varchar(pages, 5)
    assert out_valid.all()
    assert out_vals[1] == long1
    assert out_vals[3] == long2
    assert out_vals[0] == b"pre" and out_vals[2] == b"mid" and out_vals[4] == b"post"


def test_varchar_adjacent_long_strings():
    a = b"X" * (2 * PAGE_SIZE)
    b = b"Y" * (PAGE_SIZE)
    values = _obj([a, b])
    valid = np.ones(2, dtype=bool)
    pages = pc.encode_varchar(values, valid)
    out_vals, out_valid = pc.decode_varchar(pages, 2)
    assert out_vals[0] == a and out_vals[1] == b


def test_host_table_roundtrip_via_columnar():
    rows = [
        (1, "xxx"),
        (1, "yyy"),
        (NULL, "zzz"),
        (2, NULL),
        (3, "vvv"),
    ]
    types = [DataType.INT32, DataType.VARCHAR]
    host = HostTable.from_rows(rows, types)
    ct = ColumnarTable.from_host(host)
    back = ct.to_host().to_rows()
    assert back == [
        (1, b"xxx"),
        (1, b"yyy"),
        (NULL, b"zzz"),
        (2, NULL),
        (3, b"vvv"),
    ]


def test_reference_decoder_compat_fixed():
    """Emulate the reference page walker byte-for-byte on our encoded pages.

    Independent re-implementation of src/build_table.cpp:325-342 reading raw
    bytes, to pin the layout (headers, dense values, tail bitmap).
    """
    values = np.arange(10, dtype=np.int32)
    valid = np.array([True] * 5 + [False] + [True] * 4)
    pages = pc.encode_fixed(values, valid, DataType.INT32)
    assert pages.shape[0] == 1
    page = pages[0]
    nr = int(page[0]) | (int(page[1]) << 8)
    nv = int(page[2]) | (int(page[3]) << 8)
    assert nr == 10 and nv == 9
    bitmap = page[PAGE_SIZE - 2 :]
    bits = np.unpackbits(bitmap, count=nr, bitorder="little").astype(bool)
    np.testing.assert_array_equal(bits, valid)
    data = page[4 : 4 + nv * 4].view(np.int32)
    np.testing.assert_array_equal(data, values[valid])


def test_reference_decoder_compat_varchar():
    """Emulate the reference VARCHAR page walker byte-for-byte.

    Independent re-implementation of src/build_table.cpp:345-405 reading
    raw bytes: u16 num_rows / u16 num_non_null header, u16 end-offsets at
    data+4, char payload after the offsets, tail NULL bitmap, and
    long-string pages flagged num_rows==0xffff (first, u16 num_chars at
    +2) / 0xfffe (continuation appending to the previous row).
    """
    from radixjoin.storage.columnar import objects_to_heap

    values = _obj([b"ab", b"", b"xyz", b"Movie (2001)", b"L" * 9000, b"tail"])
    valid = np.array([True, True, False, True, True, True])
    heap, ends = objects_to_heap(values, valid)
    pages = pc.encode_varchar_heap(heap, ends, valid)

    rows = []
    for page in pages:
        nr = int(page[0]) | (int(page[1]) << 8)
        if nr == 0xFFFF:  # long string, first page
            nc = int(page[2]) | (int(page[3]) << 8)
            rows.append(bytes(page[4 : 4 + nc]))
            continue
        if nr == 0xFFFE:  # continuation: append to the previous row
            nc = int(page[2]) | (int(page[3]) << 8)
            rows[-1] += bytes(page[4 : 4 + nc])
            continue
        nv = int(page[2]) | (int(page[3]) << 8)
        offs = page[4 : 4 + 2 * nv].view(np.uint16)
        payload = page[4 + 2 * nv :]
        bits = np.unpackbits(
            page[PAGE_SIZE - ((nr + 7) // 8) :], count=nr, bitorder="little"
        ).astype(bool)
        k = 0
        for r in range(nr):
            if not bits[r]:
                rows.append(None)
                continue
            lo = 0 if k == 0 else int(offs[k - 1])
            rows.append(bytes(payload[lo : int(offs[k])]))
            k += 1

    expected = [v if ok else None for v, ok in zip(values, valid)]
    assert rows == expected


def test_host_pool_parallel_codec_round_trip():
    """Column-parallel encode/decode (host_pool) is bit-identical to the
    serial path (RJT_HOST_THREADS=0)."""
    import os
    import numpy as np
    from radixjoin.dtypes import DataType
    from radixjoin.storage.columnar import ColumnarTable, HostColumn, HostTable

    rng = np.random.default_rng(11)
    n = 5000
    cols = [
        HostColumn(DataType.INT32, rng.integers(-9, 9, n).astype(np.int32),
                   rng.random(n) > 0.2),
        HostColumn(DataType.INT64, rng.integers(0, 1 << 40, n).astype(np.int64),
                   rng.random(n) > 0.2),
        HostColumn(DataType.FP64, rng.random(n), rng.random(n) > 0.2),
    ]
    strs = np.empty(n, dtype=object)
    strs[:] = [b"x" * int(k) for k in rng.integers(0, 50, n)]
    strs[0] = b"y" * 20000  # long-string page chain
    cols.append(HostColumn(DataType.VARCHAR, strs, rng.random(n) > 0.2))
    table = HostTable(n, cols)

    paged = ColumnarTable.from_host(table)
    paged._host = None  # force a real decode
    rows_par = paged.to_host().to_rows()

    os.environ["RJT_HOST_THREADS"] = "0"
    try:
        paged2 = ColumnarTable.from_host(table)
        paged2._host = None
        rows_ser = paged2.to_host().to_rows()
    finally:
        del os.environ["RJT_HOST_THREADS"]
    assert rows_par == rows_ser
    for pa, pb in zip(
        (pg for c in paged.columns for pg in c.pages),
        (pg for c in paged2.columns for pg in c.pages),
    ):
        assert bytes(pa) == bytes(pb)


def test_pretty_print():
    import numpy as np
    from radixjoin.dtypes import DataType
    from radixjoin.storage.columnar import HostColumn, HostTable

    t = HostTable(2, [
        HostColumn(DataType.INT32, np.array([1, 2], np.int32),
                   np.array([True, False])),
        HostColumn(DataType.VARCHAR, np.array([b"ab", b"c"], object),
                   np.array([True, True])),
    ])
    s = t.pretty()
    assert "INT32" in s and "NULL" in s and "ab" in s
