"""Native runtime vs pure-Python reference parity."""

import numpy as np
import pytest

from radixjoin.dtypes import DataType, PAGE_SIZE
from radixjoin.storage import native
from radixjoin.storage import page as pc
from radixjoin.storage import ingest
from radixjoin.storage.columnar import (
    HostColumn,
    HostTable,
    heap_to_objects,
    objects_to_heap,
)
from radixjoin.sql.predicate import like_regex

pytestmark = pytest.mark.skipif(
    native.lib() is None, reason="native toolchain unavailable"
)


def _obj(values):
    arr = np.empty(len(values), dtype=object)
    arr[:] = values
    return arr


def test_fixed_codec_native_matches_python(monkeypatch):
    rng = np.random.default_rng(0)
    n = 30_000
    values = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    valid = rng.random(n) > 0.25
    native_pages = native.encode_fixed(values, valid, 4, 4)
    raw, nvalid = native.decode_fixed(native_pages, n, 4, 4)
    np.testing.assert_array_equal(raw.view(np.int32)[valid], values[valid])
    np.testing.assert_array_equal(nvalid, valid)
    # force the pure-python paths and check both directions
    import types as _types

    monkeypatch.setattr(
        pc,
        "native",
        _types.SimpleNamespace(
            encode_fixed=lambda *a: None,
            decode_fixed=lambda *a: None,
            encode_varchar=lambda *a: None,
            decode_varchar=lambda *a: None,
        ),
    )
    python_pages = pc.encode_fixed(values, valid, DataType.INT32)
    pvals, pvalid = pc.decode_fixed(native_pages, n, DataType.INT32)
    np.testing.assert_array_equal(pvals[valid], values[valid])
    np.testing.assert_array_equal(pvalid, valid)
    raw2, v2 = native.decode_fixed(python_pages, n, 4, 4)
    np.testing.assert_array_equal(raw2.view(np.int32)[valid], values[valid])
    np.testing.assert_array_equal(v2, valid)


def test_varchar_codec_roundtrip_native():
    rng = np.random.default_rng(1)
    n = 10_000
    lens = rng.integers(0, 30, n)
    values = _obj([bytes(rng.integers(65, 91, l).astype(np.uint8)) for l in lens])
    valid = rng.random(n) > 0.3
    heap, ends = objects_to_heap(values, valid)
    pages = native.encode_varchar(heap, ends, valid)
    h2, e2, v2 = native.decode_varchar(pages, n)
    np.testing.assert_array_equal(v2, valid)
    objs = heap_to_objects(h2, e2, v2)
    for i in range(n):
        if valid[i]:
            assert objs[i] == values[i]


def test_varchar_long_strings_native():
    long1 = b"Q" * (PAGE_SIZE * 2 + 17)
    values = _obj([b"a", long1, b"b"])
    valid = np.ones(3, dtype=bool)
    heap, ends = objects_to_heap(values, valid)
    pages = native.encode_varchar(heap, ends, valid)
    h2, e2, v2 = native.decode_varchar(pages, 3)
    objs = heap_to_objects(h2, e2, v2)
    assert objs[1] == long1 and objs[0] == b"a" and objs[2] == b"b"
    # python decoder reads native long-string pages
    pvals, pvalid = pc.decode_varchar(pages, 3)
    assert pvals[1] == long1


def test_cross_codec_compat():
    """Pages from either encoder decode identically in both decoders."""
    rng = np.random.default_rng(2)
    n = 5_000
    lens = rng.integers(0, 25, n)
    values = _obj([bytes(rng.integers(33, 127, l).astype(np.uint8)) for l in lens])
    valid = rng.random(n) > 0.4
    heap, ends = objects_to_heap(values, valid)
    native_pages = native.encode_varchar(heap, ends, valid)
    python_pages = pc.encode_varchar(values, valid)
    for pages in (native_pages, python_pages):
        pv, pvd = pc.decode_varchar(pages, n)
        h2, e2, v2 = native.decode_varchar(pages, n)
        objs = heap_to_objects(h2, e2, v2)
        np.testing.assert_array_equal(pvd, valid)
        np.testing.assert_array_equal(v2, valid)
        for i in range(n):
            if valid[i]:
                assert pv[i] == values[i] == objs[i]


def test_native_like_matches_regex():
    rng = np.random.default_rng(3)
    n = 3_000
    pool = [b"(presents)", b"(co-production)", b"Metro-Goldwyn", b"x\ny", b"", b"abc"]
    values = _obj([pool[i % len(pool)] + bytes(rng.integers(97, 123, i % 5).astype(np.uint8)) for i in range(n)])
    valid = rng.random(n) > 0.2
    heap, ends = objects_to_heap(values, valid)
    for pattern in [b"%(presents)%", b"%co%", b"a_c%", b"%", b"x_y", b"x%y", b"abc"]:
        got = native.like(heap, ends, valid, pattern, False)
        rx = like_regex(pattern)
        expected = np.array(
            [bool(valid[i]) and rx.match(bytes(values[i])) is not None for i in range(n)]
        )
        np.testing.assert_array_equal(got, expected, err_msg=f"pattern={pattern}")
        got_neg = native.like(heap, ends, valid, pattern, True)
        expected_neg = np.array(
            [bool(valid[i]) and rx.match(bytes(values[i])) is None for i in range(n)]
        )
        np.testing.assert_array_equal(got_neg, expected_neg)


def test_native_str_compare():
    values = _obj([b"apple", b"pear", b"", b"apricot"])
    valid = np.array([True, True, False, True])
    heap, ends = objects_to_heap(values, valid)
    np.testing.assert_array_equal(
        native.str_compare(heap, ends, valid, b"apple", "EQ"),
        [True, False, False, False],
    )
    np.testing.assert_array_equal(
        native.str_compare(heap, ends, valid, b"b", "LT"),
        [True, False, False, True],
    )
    np.testing.assert_array_equal(
        native.str_compare(heap, ends, valid, b"apple", "NEQ"),
        [False, True, False, True],
    )


def test_native_dict_encode():
    values = _obj([b"b", b"a", b"b", b"", b"c", b"a"])
    valid = np.array([True, True, True, False, True, True])
    heap, ends = objects_to_heap(values, valid)
    ids, dheap, dends = native.dict_encode(heap, ends, valid)
    dict_objs = heap_to_objects(dheap, dends, np.ones(len(dends), bool))
    assert list(dict_objs) == [b"a", b"b", b"c"]
    assert ids.tolist() == [1, 0, 1, 0, 2, 0]


def test_native_csv_parse(tmp_path):
    path = str(tmp_path / "t.csv")
    with open(path, "wb") as f:
        f.write(b'1,hello,2.5\n')
        f.write(b'2,"quoted, with comma",\n')
        f.write(b'3,"esc \\" quote",7\n')
        f.write(b'4,"multi\nline",8\n')
        f.write(b',,9\n')
    types = [DataType.INT32, DataType.VARCHAR, DataType.INT64]
    table = ingest.parse_csv(path, types)
    assert table.num_rows == 5
    c0, c1, c2 = table.columns
    assert c0.values.tolist() == [1, 2, 3, 4, 0]
    assert c0.valid.tolist() == [True, True, True, True, False]
    objs = c1.objects()
    assert objs[0] == b"hello"
    assert objs[1] == b"quoted, with comma"
    assert objs[2] == b'esc " quote'
    assert objs[3] == b"multi\nline"
    assert c1.valid.tolist() == [True, True, True, True, False]
    assert c2.valid.tolist() == [True, False, True, True, True]
    assert c2.values[[0, 2, 3, 4]].tolist() == [2, 7, 8, 9]


def test_native_csv_crlf(tmp_path, monkeypatch):
    """CRLF files must parse identically to LF files (the reference's
    streaming parser consumes \\r\\n, src/csv_parser.cpp) — in both the
    native parser and the pure-python fallback."""
    path = str(tmp_path / "crlf.csv")
    with open(path, "wb") as f:
        f.write(b'1,alpha\r\n')
        f.write(b'2,"quoted\r\nnewline"\r\n')
        f.write(b',beta\r\n')
    types = [DataType.INT32, DataType.VARCHAR]
    expected = [
        (1, b"alpha"),
        (2, b"quoted\r\nnewline"),  # quoted CRLF is data, not a row break
    ]

    from radixjoin.dtypes import NULL

    table = ingest.parse_csv(path, types)
    assert table.num_rows == 3
    rows = table.to_rows()
    assert [tuple(r) for r in rows[:2]] == expected
    assert rows[2] == (NULL, b"beta")  # empty field -> NULL int

    import types as _types

    monkeypatch.setattr(
        ingest, "native",
        _types.SimpleNamespace(parse_csv=lambda *a: None),
    )
    table_py = ingest.parse_csv(path, types)
    assert table_py.to_rows() == rows


def test_csv_roundtrip_via_write(tmp_path):
    from radixjoin.dtypes import NULL

    rows = [
        (1, "plain"),
        (2, 'with "quotes"'),
        (3, "comma, inside"),
        (NULL, "back\\slash"),
        (5, NULL),
    ]
    table = HostTable.from_rows(rows, [DataType.INT32, DataType.VARCHAR])
    path = str(tmp_path / "rt.csv")
    ingest.write_csv(path, table)
    back = ingest.parse_csv(path, [DataType.INT32, DataType.VARCHAR])
    assert back.to_rows() == [
        (1, b"plain"),
        (2, b'with "quotes"'),
        (3, b"comma, inside"),
        (NULL, b"back\\slash"),
        (5, NULL),
    ]


def test_gather_varlen_native_matches_numpy():
    from radixjoin.storage import native as native_mod

    rng = np.random.default_rng(3)
    n = 5000
    lengths_src = rng.integers(0, 40, n).astype(np.int64)
    heap_len = int(lengths_src.sum()) + 64
    heap = rng.integers(0, 256, heap_len).astype(np.uint8)
    starts = np.zeros(n, np.int64)
    pos = 0
    for i in range(n):
        starts[i] = pos
        pos += lengths_src[i]
    sel = rng.permutation(n)[: n // 2]
    s, ln = starts[sel], lengths_src[sel]
    new_ends = np.cumsum(ln)
    total = int(ln.sum())
    native_out = native_mod.gather_varlen(heap, s, ln, new_ends, total)
    assert native_out is not None  # toolchain is present in CI
    out_starts = new_ends - ln
    nz = ln > 0
    src = (
        np.repeat(s[nz] - out_starts[nz], ln[nz])
        + np.arange(total, dtype=np.int64)
    )
    np.testing.assert_array_equal(native_out, heap[src])
