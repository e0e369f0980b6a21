"""Correctness oracles.

Two independent row-level ground-truth paths, replacing the reference's
DuckDB check (tests/read_sql.cpp:1159-1249), plus a vectorized plan
reference that carries their check to sizes they cannot reach:

1. :func:`execute_plan_rows` — a deliberately naive row-at-a-time
   interpreter over the same ``Plan`` (dict-based hash join, scalar filter
   eval). It shares *no* code with the vectorized device engine, so it
   validates the engine's kernels and data movement.
2. :func:`SqliteOracle` — loads the synthetic tables into sqlite and runs
   the rewritten raw-column SQL (``ParsedSQL.executed_sql``), validating the
   whole stack (SQL frontend + plan conversion + engine) from the query
   text. LIKE is overridden with the engine's exact byte-level matcher.
3. :func:`execute_plan_numpy` — the same ``Plan`` evaluated column at a
   time in numpy (sort + searchsorted + repeat joins). It too shares no
   code with ``ops/`` or ``plan/``; it is checked against (1) and (2) at
   small scale and then stands in for them at tens of millions of rows.

Comparison is multiset equality over rows, like the reference's sorted
row-by-row compare (:func:`rows_equal` on row tuples, :func:`tables_equal`
column-wise on whole tables).
"""

from __future__ import annotations

import sqlite3
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..dtypes import NULL, DataType, is_null
from ..plan.ir import JoinNode, Plan, ScanNode
from ..sql import catalog
from ..sql.predicate import like_match
from ..storage.columnar import HostColumn, HostTable

# ---------------------------------------------------------------------------
# Plan-level row oracle
# ---------------------------------------------------------------------------


def execute_plan_rows(plan: Plan) -> List[tuple]:
    """Row-at-a-time reference execution of a Plan (oracle only; slow)."""
    plan.validate()
    results: Dict[int, List[tuple]] = {}
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            host = plan.inputs[node.data.base_table_id].to_host()
            rows = host.to_rows()
            cols = [c for c, _ in node.output_attrs]
            results[idx] = [tuple(r[c] for c in cols) for r in rows]
        else:
            results[idx] = _join_rows(plan, node.data, node.output_attrs, results)
    return results[plan.root]


def _join_rows(plan: Plan, join: JoinNode, output_attrs, results) -> List[tuple]:
    left = results[join.left]
    right = results[join.right]
    if not left or not right:
        return []
    left_w = len(plan.nodes[join.left].output_attrs)
    left_key_t = plan.nodes[join.left].output_attrs[join.left_attr][1]
    right_key_t = plan.nodes[join.right].output_attrs[join.right_attr][1]
    if left_key_t is not right_key_t:
        # variant-extraction semantics: mismatched key types never match
        return []
    if join.build_left:
        build, probe = left, right
        build_attr, probe_attr = join.left_attr, join.right_attr
    else:
        build, probe = right, left
        build_attr, probe_attr = join.right_attr, join.left_attr
    index: Dict[object, List[int]] = {}
    for i, row in enumerate(build):
        k = row[build_attr]
        if is_null(k):
            continue
        if isinstance(k, float) and k != k:  # NaN never matches
            continue
        index.setdefault(k, []).append(i)
    out: List[tuple] = []
    cols = [c for c, _ in output_attrs]
    for j, prow in enumerate(probe):
        k = prow[probe_attr]
        if is_null(k):
            continue
        matches = index.get(k)
        if not matches:
            continue
        for bi in matches:
            lrow = build[bi] if join.build_left else prow
            rrow = prow if join.build_left else build[bi]
            out.append(
                tuple(
                    lrow[c] if c < left_w else rrow[c - left_w] for c in cols
                )
            )
    return out


# ---------------------------------------------------------------------------
# Vectorized plan reference
# ---------------------------------------------------------------------------


def execute_plan_numpy(plan: Plan) -> HostTable:
    """Column-at-a-time reference execution of a Plan in numpy.

    Every join sorts the valid build keys, bounds each valid probe key's
    run of equal build keys with two searchsorteds, and expands the
    matches with ``np.repeat``: NULL keys never match, duplicates fan out,
    a key-type mismatch or an empty child gives an empty join (reference
    src/execute.cpp:50, :62-83)."""
    plan.validate()
    results: Dict[int, HostTable] = {}
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            host = plan.inputs[node.data.base_table_id].to_host()
            results[idx] = HostTable(
                host.num_rows, [host.columns[c] for c, _ in node.output_attrs]
            )
        else:
            results[idx] = _join_numpy(
                plan, node.data, node.output_attrs, results
            )
    return results[plan.root]


def _empty_numpy(output_attrs) -> HostTable:
    cols = []
    for _, dt in output_attrs:
        if dt is DataType.VARCHAR:
            cols.append(HostColumn.varchar(
                np.zeros(0, np.uint8), np.zeros(0, np.int64),
                np.zeros(0, bool),
            ))
        else:
            cols.append(
                HostColumn(dt, np.zeros(0, dt.numpy_dtype), np.zeros(0, bool))
            )
    return HostTable(0, cols)


def _numpy_keys(b: HostColumn, p: HostColumn):
    """int64 keys + validity for both sides with equal keys equal."""
    if b.dtype is DataType.VARCHAR:
        both = np.concatenate([
            np.where(b.valid, b.objects(), b""),
            np.where(p.valid, p.objects(), b""),
        ])
        _, codes = np.unique(both, return_inverse=True)
        codes = codes.astype(np.int64).reshape(-1)
        return (codes[:len(b)], b.valid), (codes[len(b):], p.valid)
    if b.dtype is DataType.FP64:
        def canon(c):
            # -0.0 == +0.0 matches; NaN never matches
            v = np.where(c.values == 0.0, 0.0, c.values)
            return v.view(np.int64), c.valid & ~np.isnan(c.values)

        return canon(b), canon(p)
    return (
        (b.values.astype(np.int64), b.valid),
        (p.values.astype(np.int64), p.valid),
    )


def _join_numpy(plan: Plan, join: JoinNode, output_attrs, results) -> HostTable:
    left, right = results[join.left], results[join.right]
    lt = plan.nodes[join.left].output_attrs[join.left_attr][1]
    rt = plan.nodes[join.right].output_attrs[join.right_attr][1]
    if left.num_rows == 0 or right.num_rows == 0 or lt is not rt:
        return _empty_numpy(output_attrs)
    if join.build_left:
        build, probe = left, right
        battr, pattr = join.left_attr, join.right_attr
    else:
        build, probe = right, left
        battr, pattr = join.right_attr, join.left_attr
    (kb, vb), (kp, vp) = _numpy_keys(
        build.columns[battr], probe.columns[pattr]
    )
    bsel = np.flatnonzero(vb)
    order = bsel[np.argsort(kb[bsel], kind="stable")]
    sorted_keys = kb[order]
    psel = np.flatnonzero(vp)
    lo = np.searchsorted(sorted_keys, kp[psel], side="left")
    hi = np.searchsorted(sorted_keys, kp[psel], side="right")
    counts = hi - lo
    total = int(counts.sum())
    offsets = np.cumsum(counts) - counts
    pidx = np.repeat(psel, counts)
    bidx = order[np.arange(total) + np.repeat(lo - offsets, counts)]
    lidx, ridx = (bidx, pidx) if join.build_left else (pidx, bidx)
    left_w = left.num_cols
    cols = [
        left.columns[c].take(lidx) if c < left_w
        else right.columns[c - left_w].take(ridx)
        for c, _ in output_attrs
    ]
    return HostTable(total, cols)


# ---------------------------------------------------------------------------
# SQLite oracle
# ---------------------------------------------------------------------------


class SqliteOracle:
    """In-memory sqlite mirror of a set of host tables."""

    def __init__(self, tables: Dict[str, HostTable]):
        self.conn = sqlite3.connect(":memory:")
        self.conn.create_function("like", 2, self._like, deterministic=True)
        for name, table in tables.items():
            self._load(name, table)
        # index id/fk columns so 20-table joins stay tractable
        cur = self.conn.cursor()
        for name in tables:
            for column, dtype in catalog.ATTRIBUTES[name]:
                if column == "id" or column.endswith("_id"):
                    cur.execute(
                        f"CREATE INDEX idx_{name}_{column} ON {name}({column})"
                    )
        self.conn.commit()

    @staticmethod
    def _like(pattern, value):
        # sqlite calls like(P, X) for "X LIKE P"; exact byte semantics.
        # NULL operands must yield SQL NULL (not False!) so that
        # "x NOT LIKE p" excludes NULL rows: NOT NULL -> NULL -> filtered.
        if pattern is None or value is None:
            return None
        p = pattern.encode("latin-1") if isinstance(pattern, str) else pattern
        v = value.encode("latin-1") if isinstance(value, str) else value
        return like_match(v, p)

    def _load(self, name: str, table: HostTable) -> None:
        attrs = catalog.ATTRIBUTES[name]
        decls = []
        for (column, dtype), col in zip(attrs, table.columns):
            sql_type = "TEXT" if dtype is DataType.VARCHAR else (
                "REAL" if dtype is DataType.FP64 else "INTEGER"
            )
            decls.append(f"{column} {sql_type}")
        cur = self.conn.cursor()
        cur.execute(f"CREATE TABLE {name} ({', '.join(decls)})")
        n = table.num_rows
        cols = table.columns
        col_objs = [
            c.objects() if c.dtype is DataType.VARCHAR else c.values for c in cols
        ]
        placeholders = ", ".join(["?"] * len(cols))
        rows = []
        for i in range(n):
            row = []
            for c, vals in zip(cols, col_objs):
                if not c.valid[i]:
                    row.append(None)
                elif c.dtype is DataType.VARCHAR:
                    row.append(bytes(vals[i]).decode("latin-1"))
                elif c.dtype is DataType.FP64:
                    row.append(float(vals[i]))
                else:
                    row.append(int(vals[i]))
            rows.append(tuple(row))
        cur.executemany(f"INSERT INTO {name} VALUES ({placeholders})", rows)
        self.conn.commit()

    def query(self, sql: str) -> List[tuple]:
        cur = self.conn.cursor()
        cur.execute(sql)
        out = []
        for row in cur.fetchall():
            out.append(
                tuple(
                    NULL
                    if v is None
                    else (v.encode("latin-1") if isinstance(v, str) else v)
                    for v in row
                )
            )
        return out


# ---------------------------------------------------------------------------
# Multiset comparison
# ---------------------------------------------------------------------------


def _canonical(row: tuple) -> tuple:
    out = []
    for v in row:
        if is_null(v):
            out.append(("\0null",))
        elif isinstance(v, float):
            out.append(("f", v))
        elif isinstance(v, bytes):
            out.append(("s", v))
        else:
            out.append(("i", int(v)))
    return tuple(out)


def rows_equal(
    actual: List[tuple], expected: List[tuple]
) -> Tuple[bool, Optional[str]]:
    """Exact multiset comparison (order-insensitive, NULL-safe)."""
    if len(actual) != len(expected):
        return False, f"row count {len(actual)} != expected {len(expected)}"
    ca = Counter(map(_canonical, actual))
    ce = Counter(map(_canonical, expected))
    if ca != ce:
        missing = ce - ca
        extra = ca - ce
        msg = []
        for r, k in list(missing.items())[:3]:
            msg.append(f"missing x{k}: {r}")
        for r, k in list(extra.items())[:3]:
            msg.append(f"extra x{k}: {r}")
        return False, "; ".join(msg)
    return True, None


def _column_codes(a: HostColumn, b: HostColumn):
    """Per-row int64 codes for two same-typed columns: equal values get
    equal codes, NULL is 0."""
    if a.dtype is DataType.VARCHAR:
        both = np.concatenate([
            np.where(a.valid, a.objects(), b""),
            np.where(b.valid, b.objects(), b""),
        ])
    else:
        vals = np.concatenate([a.values, b.values])
        both = vals.view(np.int64) if a.dtype is DataType.FP64 else vals
    _, codes = np.unique(both, return_inverse=True)
    codes = codes.astype(np.int64).reshape(-1) + 1
    codes[~np.concatenate([a.valid, b.valid])] = 0
    return codes[:len(a)], codes[len(a):]


def tables_equal(
    actual: HostTable, expected: HostTable
) -> Tuple[bool, Optional[str]]:
    """Exact multiset comparison of two tables, column-wise (FP64 by bit
    pattern). The vectorized counterpart of :func:`rows_equal` for
    results too large for row tuples."""
    if actual.num_rows != expected.num_rows:
        return False, (
            f"row count {actual.num_rows} != expected {expected.num_rows}"
        )
    if [c.dtype for c in actual.columns] != [c.dtype for c in expected.columns]:
        return False, "column types differ"
    if actual.num_rows == 0:
        return True, None
    pairs = [_column_codes(a, e)
             for a, e in zip(actual.columns, expected.columns)]
    ka = np.stack([p[0] for p in pairs])
    ke = np.stack([p[1] for p in pairs])
    ka = ka[:, np.lexsort(ka[::-1])]
    ke = ke[:, np.lexsort(ke[::-1])]
    diff = np.flatnonzero((ka != ke).any(axis=0))
    if len(diff):
        return False, (
            f"{len(diff)} of {actual.num_rows} sorted rows differ "
            f"(first at sorted row {int(diff[0])})"
        )
    return True, None
