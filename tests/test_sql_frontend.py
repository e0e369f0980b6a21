"""SQL parser / frontend / predicate tests."""

import numpy as np
import pytest

from radixjoin.dtypes import DataType, NULL
from radixjoin.sql.frontend import ParsedSQL, TableEntity
from radixjoin.sql.parser import parse_sql
from radixjoin.sql.predicate import Comparison, LogicalOperation, Op, like_match
from radixjoin.storage.columnar import HostTable


def test_parse_basic_query():
    stmt = parse_sql(
        "SELECT MIN(t.title) AS movie_title FROM title AS t, movie_companies AS mc "
        "WHERE t.id = mc.movie_id AND t.production_year > 1990;"
    )
    assert len(stmt.select_list) == 1
    assert stmt.select_list[0].aggregate == "MIN"
    assert stmt.tables == [("title", "t"), ("movie_companies", "mc")]


def test_parsed_sql_join_graph_and_filters():
    sql = (
        "SELECT MIN(t.title) FROM title AS t, movie_companies AS mc, "
        "company_type AS ct WHERE ct.kind = 'production companies' AND "
        "t.production_year BETWEEN 1990 AND 2000 AND ct.id = mc.company_type_id "
        "AND t.id = mc.movie_id;"
    )
    parsed = ParsedSQL(sql)
    t = TableEntity("title", 0)
    mc = TableEntity("movie_companies", 0)
    ct = TableEntity("company_type", 0)
    assert parsed.output_attrs == [(t, "title")]
    assert mc in parsed.join_graph[t]
    assert parsed.join_graph[t][mc] == ("id", "movie_id")
    assert parsed.join_graph[mc][ct] == ("company_type_id", "id")
    # filters pushed per entity
    assert ct in parsed.filters and t in parsed.filters
    assert mc not in parsed.filters
    # BETWEEN lowered to GEQ AND LEQ
    f = parsed.filters[t]
    assert isinstance(f, LogicalOperation)


def test_transitive_join_closure():
    """t.id = mc.movie_id AND t.id = mi.movie_id implies mc<->mi edge."""
    sql = (
        "SELECT t.title FROM title AS t, movie_companies AS mc, movie_info AS mi "
        "WHERE t.id = mc.movie_id AND t.id = mi.movie_id;"
    )
    parsed = ParsedSQL(sql)
    mc = TableEntity("movie_companies", 0)
    mi = TableEntity("movie_info", 0)
    assert mi in parsed.join_graph[mc]
    assert parsed.join_graph[mc][mi] == ("movie_id", "movie_id")


def test_same_table_twice():
    sql = (
        "SELECT t1.title FROM title AS t1, title AS t2, movie_link AS ml "
        "WHERE t1.id = ml.movie_id AND t2.id = ml.linked_movie_id;"
    )
    parsed = ParsedSQL(sql)
    assert parsed.table_counts["title"] == 2
    assert TableEntity("title", 0) in parsed.column_map
    assert TableEntity("title", 1) in parsed.column_map


def test_executed_sql_rewrite():
    sql = "SELECT MIN(t.title) AS x FROM title AS t WHERE t.production_year > 2000;"
    parsed = ParsedSQL(sql)
    out = parsed.executed_sql()
    assert out.startswith("SELECT t.title FROM title AS t")
    assert "MIN" not in out


def test_or_filter_same_entity():
    sql = (
        "SELECT mc.note FROM movie_companies AS mc, title AS t WHERE "
        "(mc.note LIKE '%(co-production)%' OR mc.note LIKE '%(presents)%') "
        "AND t.id = mc.movie_id;"
    )
    parsed = ParsedSQL(sql)
    mc = TableEntity("movie_companies", 0)
    assert isinstance(parsed.filters[mc], LogicalOperation)


def test_or_across_entities_rejected():
    sql = (
        "SELECT t.title FROM title AS t, movie_companies AS mc WHERE "
        "(t.production_year > 2000 OR mc.note LIKE '%x%') AND t.id = mc.movie_id;"
    )
    with pytest.raises(ValueError):
        ParsedSQL(sql)


def test_join_condition_inside_or_rejected():
    sql = (
        "SELECT t.title FROM title AS t, movie_companies AS mc WHERE "
        "t.production_year > 2000 OR t.id = mc.movie_id;"
    )
    with pytest.raises(ValueError):
        ParsedSQL(sql)


def test_like_match_semantics():
    assert like_match(b"(presents)", b"%(presents)%")
    assert like_match(b"abc", b"a_c")
    assert not like_match(b"abc", b"a_d")
    assert like_match(b"anything", b"%")
    # regex metacharacters in patterns are literal
    assert like_match(b"a.c", b"a.c")
    assert not like_match(b"abc", b"a.c")
    # '.' must not match newline (RE2 default)
    assert not like_match(b"a\nc", b"a_c")


def test_comparison_null_semantics():
    table = HostTable.from_rows(
        [(1, "x"), (NULL, "y"), (3, NULL)],
        [DataType.INT32, DataType.VARCHAR],
    )
    neq = Comparison(0, Op.NEQ, 1)
    np.testing.assert_array_equal(neq.eval_table(table), [False, False, True])
    isnull = Comparison(1, Op.IS_NULL)
    np.testing.assert_array_equal(isnull.eval_table(table), [False, False, True])
    notlike = Comparison(1, Op.NOT_LIKE, "z%")
    np.testing.assert_array_equal(notlike.eval_table(table), [True, True, False])
    # NOT flips NULL rows to true (reference bitmap semantics)
    noteq = LogicalOperation.make_not(Comparison(0, Op.EQ, 1))
    np.testing.assert_array_equal(noteq.eval_table(table), [False, True, True])
    # row eval agrees with columnar eval
    rows = table.to_rows()
    for stmt in (neq, isnull, notlike, noteq):
        col = stmt.eval_table(table)
        for i, row in enumerate(rows):
            assert stmt.eval_row(row) == bool(col[i])


def test_string_comparisons():
    table = HostTable.from_rows(
        [("apple",), ("pear",), (NULL,)], [DataType.VARCHAR]
    )
    lt = Comparison(0, Op.LT, "b")
    np.testing.assert_array_equal(lt.eval_table(table), [True, False, False])
    eq = Comparison(0, Op.EQ, "pear")
    np.testing.assert_array_equal(eq.eval_table(table), [False, True, False])


def test_numeric_literal_on_string_column_false():
    table = HostTable.from_rows([("5",)], [DataType.VARCHAR])
    eq = Comparison(0, Op.EQ, 5)
    np.testing.assert_array_equal(eq.eval_table(table), [False])


def test_all_113_queries_parse():
    """Every in-repo workload query parses, and says it is synthetic."""
    from radixjoin.harness.run import load_workload

    names, _, queries = load_workload()
    assert len(names) >= 10
    for name, sql in zip(names, queries):
        parsed = ParsedSQL(sql, name)
        assert parsed.output_attrs
        assert parsed.join_graph
        assert "synthetic" in sql.lower().split("select")[0]
