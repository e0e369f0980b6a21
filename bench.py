#!/usr/bin/env python
"""Benchmark: the in-repo synthetic JOB-shaped workload on one GPU.

Mirrors the reference's benchmark protocol (tests/read_sql.cpp:1251-1333):
per-query timing covers ``execute()`` only (plan construction and
base-table filtering excluded); the metric is the warm serial suite total.
The workload is workloads/job_shaped on the synthetic IMDB
(harness/datagen.py) at BENCH_SCALE (default 0.1). The same plans also run
as one ``execute_many()`` batch, reported in ``detail.batch_wall_ms``.

Fails when JAX finds no GPU. Env knobs: BENCH_SCALE, BENCH_QUERIES (comma
list), BENCH_REPEAT (timed passes, per-query best-of). Prints exactly one
JSON line on stdout, naming the device it ran on.
"""

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    scale = float(os.environ.get("BENCH_SCALE", "0.1"))
    repeat = int(os.environ.get("BENCH_REPEAT", "2"))

    # read before JAX touches the card
    card = None
    if shutil.which("nvidia-smi"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
        ).stdout.strip()
    import jax

    from radixjoin.harness import datagen
    from radixjoin.harness.run import (
        DEFAULT_PLANS, JobHarness, TableSource, enable_compile_cache,
        load_workload, select_platform,
    )

    select_platform("gpu")
    enable_compile_cache()
    dev = jax.devices()[0]

    names, _, queries = load_workload()
    if os.environ.get("BENCH_QUERIES"):
        names = [n for n in os.environ["BENCH_QUERIES"].split(",") if n]
    log(f"bench: devices={jax.devices()} scale={scale} queries={len(names)}")

    t0 = time.perf_counter()
    tables = datagen.generate_cached(
        scale, 0, queries, cache_dir=os.path.join(REPO, ".bench_cache")
    )
    log(f"bench: synthetic IMDB in {time.perf_counter() - t0:.1f}s "
        f"({sum(t.num_rows for t in tables.values())} rows)")
    harness = JobHarness(DEFAULT_PLANS, TableSource(host_tables=tables))
    plans = {name: harness.build_plan(name)[1] for name in names}

    from radixjoin import engine, execute, execute_many

    # warmup: the first execution compiles and learns cardinality
    # feedback, the second compiles the feedback-specialized program
    t0 = time.perf_counter()
    result_rows = 0
    for name in names:
        result_rows += execute(plans[name], harness.context).num_rows
        execute(plans[name], harness.context)
    warmup_s = time.perf_counter() - t0
    log(f"bench: warmup {warmup_s:.1f}s")

    per_query: dict = {}
    stage_totals: dict = {}
    for _ in range(max(1, repeat)):
        totals: dict = {}
        for name in names:
            t0 = time.perf_counter()
            execute(plans[name], harness.context)
            dt = (time.perf_counter() - t0) * 1e3
            per_query[name] = min(per_query.get(name, dt), dt)
            for k, v in (getattr(plans[name], "_last_exec_stats", None)
                         or {}).items():
                totals[k] = totals.get(k, 0.0) + v
        if not stage_totals or sum(totals.values()) < sum(
                stage_totals.values()):
            stage_totals = totals
    degradations = engine.engine_stats()

    batch_best = None
    for _ in range(2):
        t0 = time.perf_counter()
        execute_many([plans[n] for n in names], harness.context)
        dt = (time.perf_counter() - t0) * 1e3
        batch_best = dt if batch_best is None else min(batch_best, dt)

    print(json.dumps({
        "metric": f"job_shaped_synthetic_sf{scale}_total_ms",
        "value": round(sum(per_query.values()), 2),
        "unit": "ms",
        "detail": {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": card,
            "queries": len(names),
            "result_rows": result_rows,
            "per_query_ms": {k: round(v, 3) for k, v in per_query.items()},
            "stage_split_ms": {k: round(v, 1)
                               for k, v in stage_totals.items()},
            "batch_wall_ms": round(batch_best, 2),
            "warmup_s": round(warmup_s, 1),
            "degradations": degradations,
        },
    }), flush=True)


if __name__ == "__main__":
    main()
