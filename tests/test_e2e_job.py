"""End-to-end JOB queries on synthetic IMDB vs two independent oracles.

Mirrors the reference's integration strategy (every query cross-checked
row-for-row against DuckDB, tests/read_sql.cpp:1224-1249) using (a) a
row-at-a-time plan interpreter and (b) sqlite running the rewritten SQL.
The queries are the in-repo synthetic JOB-shaped workload
(workloads/job_shaped), all of which run here.
"""

import pytest

from radixjoin.harness import datagen, oracle
from radixjoin.harness.run import (
    DEFAULT_PLANS, JobHarness, TableSource, load_workload,
)

# spans: FK chains, a table twice (title via movie_link), complete_cast,
# OR filters, IN lists, BETWEEN, IS NULL, duplicate-heavy cast_info x
# aka_name, a 14-table tree
CI_QUERIES = ["s1", "s2", "s3", "s5", "s8", "s10", "s11", "s16", "s17",
              "s21", "s29", "s32"]


@pytest.fixture(scope="module")
def setup():
    _, _, queries = load_workload()
    gen = datagen.SyntheticIMDB(scale=0.0004, seed=7, queries=queries)
    tables = gen.generate()
    source = TableSource(host_tables=tables)
    harness = JobHarness(DEFAULT_PLANS, source)
    sqlite_oracle = oracle.SqliteOracle(tables)
    return harness, sqlite_oracle


@pytest.mark.parametrize("name", CI_QUERIES)
def test_job_query(setup, name):
    harness, sqlite_oracle = setup
    result, runtime_ms, correct, detail = harness.run_query(
        name, verify=True, sqlite_oracle=sqlite_oracle
    )
    assert correct, f"{name}: {detail}"


@pytest.mark.parametrize("name", CI_QUERIES)
def test_numpy_reference_matches_row_oracle(setup, name):
    """The vectorized numpy plan reference (the check at sizes the row
    oracles cannot reach) agrees with the row interpreter."""
    harness, _ = setup
    _, plan = harness.build_plan(name)
    reference = oracle.execute_plan_numpy(plan)
    ok, detail = oracle.rows_equal(
        reference.to_rows(), oracle.execute_plan_rows(plan)
    )
    assert ok, f"{name}: {detail}"


@pytest.mark.parametrize("env", [
    {"RJT_UNIQUE_JOIN": "auto"},
    {"RJT_CSR_JOIN": "auto"},
    {"RJT_UNIQUE_JOIN": "auto", "RJT_CSR_JOIN": "auto"},
])
@pytest.mark.parametrize("name", ["s1", "s8", "s16", "s29"])
def test_job_query_sortfree_paths(setup, monkeypatch, env, name):
    """The sort-free fast paths (dense-window scatter FK->PK join,
    host-CSR general join) are opt-in (see plan/executor.py gates); force
    them here so the oracle cross-check covers those executor paths too."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    harness, sqlite_oracle = setup
    result, runtime_ms, correct, detail = harness.run_query(
        name, verify=True, sqlite_oracle=sqlite_oracle
    )
    assert correct, f"{name} with {env}: {detail}"


def test_job_query_from_csv_ingest(setup, tmp_path):
    """Full CSV ingest path (reference Table::from_csv,
    build_table.cpp:135-304): the same synthetic tables written to
    reference-dialect CSVs, parsed back by the native streaming parser
    with filter pushdown, must produce identical query results."""
    from radixjoin.storage import ingest

    harness, sqlite_oracle = setup
    tables = harness.source.host_tables
    csv_dir = tmp_path / "imdb"
    csv_dir.mkdir()
    for name, table in tables.items():
        ingest.write_csv(str(csv_dir / f"{name}.csv"), table)

    csv_source = TableSource(csv_dir=str(csv_dir))
    csv_harness = JobHarness(DEFAULT_PLANS, csv_source)
    try:
        for name in ("s1", "s3", "s16"):
            result, _, correct, detail = csv_harness.run_query(
                name, verify=True, sqlite_oracle=sqlite_oracle
            )
            assert correct, f"{name} via CSV ingest: {detail}"
    finally:
        csv_harness.close()


def test_execute_many_matches_serial(setup):
    """Batch (throughput) execution must be result-identical to per-plan
    execute(), including plans the fused compiler declines (VARCHAR join
    keys fall back inline) and cold-run overflow retries."""
    from radixjoin import execute, execute_many

    harness, _ = setup
    names = ["s1", "s3", "s8", "s16", "s29", "s32"]
    plans = [harness.build_plan(n)[1] for n in names]
    serial = [execute(p, harness.context) for p in plans]
    batch = execute_many(plans, harness.context)
    for name, a, b in zip(names, serial, batch):
        ok, msg = oracle.rows_equal(
            a.to_host().to_rows(), b.to_host().to_rows()
        )
        assert ok, f"{name}: {msg}"
