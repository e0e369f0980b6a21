"""One process of a multi-host distributed-join cluster (test worker).

Launched N times by ``tests/test_multihost.py`` (and usable by hand for
ad-hoc cluster runs). Each process owns ``--local-devices`` CPU devices;
together they form one global mesh over which ``execute_distributed``
runs the whole plan SPMD — the cross-process form of the capability in
SURVEY.md §7 build order step 6 (the reference has no network code at
all, SURVEY.md §2 checklist).

Every process builds the identical plan from a seeded generator (the
replicated-input contract of ``parallel/multihost.py``), executes, and
checks the gathered result against the row-semantics oracle, so a
collective mis-route on ANY rank fails that rank's assertion.

Usage:
  python tools/multihost_worker.py --pid 0 --nprocs 2 --port 19841 \
      --local-devices 4 --out /tmp/rank0.txt
"""

import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenario", default="two_join",
                    choices=["two_join", "skew", "empty", "bench_join",
                             "job"])
    ap.add_argument("--bench-rows", type=int, default=1 << 20,
                    help="global probe rows for --scenario bench_join")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--plans", default=None,
                    help="plans.json for --scenario job (default: the "
                         "in-repo workload)")
    ap.add_argument("--scale", type=float, default=0.1,
                    help="synthetic IMDB scale for --scenario job")
    ap.add_argument("--job-queries", default="s1,s3,s8,s16",
                    help="comma-separated query names for --scenario job")
    ap.add_argument("--dist-chunks", type=int, default=0,
                    help=">0: run the exchange in this many overlappable "
                         "key-space chunks (DistJoinConfig.exchange_chunks)")
    args = ap.parse_args()

    # Platform must be pinned before any backend initializes.
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags
            + f" --xla_force_host_platform_device_count={args.local_devices}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from radixjoin.parallel import multihost

    multihost.init(f"localhost:{args.port}", args.nprocs, args.pid)
    assert jax.process_count() == args.nprocs
    assert jax.device_count() == args.nprocs * args.local_devices

    import numpy as np

    if args.scenario == "bench_join":
        _bench_join(args)
        return
    if args.scenario == "job":
        _job_suite(args)
        return

    from radixjoin.dtypes import DataType
    from radixjoin.harness import oracle
    from radixjoin.parallel import make_mesh
    from radixjoin.parallel.dist_executor import execute_distributed
    from radixjoin.plan.ir import Plan
    from radixjoin.storage.columnar import ColumnarTable, HostTable

    rng = np.random.default_rng(42)  # identical tables on every rank

    def int_col(n, lo, hi, null_frac):
        vals = rng.integers(lo, hi, n)
        nulls = rng.random(n) < null_frac
        return [None if nz else int(v) for v, nz in zip(vals, nulls)]

    n_a, n_b, n_c = 3000, 800, 1200
    # table a: fact side with a skewed FK (heavy hitter key 7);
    # --scenario skew makes the hitter dominate (70% of the probe side —
    # the hot-key broadcast path carries most of the join),
    # --scenario empty disjoins the final VARCHAR join (zero-result root:
    # pins the learned-empty distributed replay)
    fk = rng.integers(0, 600, n_a)
    fk[rng.random(n_a) < (0.70 if args.scenario == "skew" else 0.30)] = 7
    rows_a = [
        [None if rng.random() < 0.03 else int(k), float(i) / 3.0, i]
        for i, k in enumerate(fk)
    ]
    rows_b = [
        [int(k), f"name_{k}".encode()] for k in rng.permutation(900)[:n_b]
    ]
    rows_c = [[v, i] for i, v in enumerate(int_col(n_c, 0, 50, 0.05))]

    ta = HostTable.from_rows(rows_a, [DataType.INT64, DataType.FP64, DataType.INT64])
    tb = HostTable.from_rows(rows_b, [DataType.INT64, DataType.VARCHAR])
    tc = HostTable.from_rows(rows_c, [DataType.INT32, DataType.INT64])

    plan = Plan()
    sa = plan.new_scan_node(
        plan.new_input(ColumnarTable.from_host(ta)),
        [(0, DataType.INT64), (1, DataType.FP64), (2, DataType.INT64)],
    )
    sb = plan.new_scan_node(
        plan.new_input(ColumnarTable.from_host(tb)),
        [(0, DataType.INT64), (1, DataType.VARCHAR)],
    )
    j1 = plan.new_join_node(
        True, sb, sa, 0, 0,
        [(1, DataType.VARCHAR), (2, DataType.INT64), (3, DataType.FP64),
         (4, DataType.INT64)],
    )
    sc = plan.new_scan_node(
        plan.new_input(ColumnarTable.from_host(tc)),
        [(0, DataType.INT32), (1, DataType.INT64)],
    )
    # j1 col 3 is a's row id (INT64); join (j1 ⋈ c) on small-domain keys:
    # remap a's row id into [0,50) via modulo is not expressible in the
    # plan IR, so join instead on c.v (INT32) vs ... keep types equal:
    # join j1.k2 (INT64 payload a-rowid) with c.payload (INT64) — sparse
    # matches exercise the near-empty path; the heavy lifting is j1.
    j2 = plan.new_join_node(
        False, j1, sc, 3, 1,
        [(0, DataType.VARCHAR), (1, DataType.INT64), (2, DataType.FP64),
         (4, DataType.INT32)],
    )
    # table d: VARCHAR join key — pins the cross-process unified-dictionary
    # path (host np.unique + replicated LUT upload on a multi-process mesh);
    # the empty scenario's d-keys match nothing
    d_prefix = "gone" if args.scenario == "empty" else "name"
    rows_d = [[f"{d_prefix}_{k}".encode(), int(k)] for k in range(0, 900, 3)]
    td = HostTable.from_rows(rows_d, [DataType.VARCHAR, DataType.INT32])
    sd = plan.new_scan_node(
        plan.new_input(ColumnarTable.from_host(td)),
        [(0, DataType.VARCHAR), (1, DataType.INT32)],
    )
    j3 = plan.new_join_node(
        True, j2, sd, 0, 0,
        [(0, DataType.VARCHAR), (3, DataType.INT32), (5, DataType.INT32),
         (2, DataType.FP64)],
    )
    plan.root = j3

    config = None
    if args.dist_chunks > 0:
        from radixjoin.parallel import DistJoinConfig

        config = DistJoinConfig(exchange_chunks=args.dist_chunks)
    mesh = make_mesh()
    result = execute_distributed(plan, mesh=mesh, config=config)
    actual = result.to_rows()
    expected = oracle.execute_plan_rows(plan)
    correct, detail = oracle.rows_equal(actual, expected)
    assert correct, f"rank {args.pid}: {detail}"
    # repeat: the warm sync-free feedback replay must stay exact across
    # the real multi-process cluster (every rank replays in lockstep)
    warm = execute_distributed(plan, mesh=mesh, config=config).to_rows()
    correct, detail = oracle.rows_equal(warm, expected)
    assert correct, f"rank {args.pid} warm replay: {detail}"

    with open(args.out, "w") as f:
        f.write(f"OK {len(actual)}\n")
    print(f"[rank {args.pid}] OK rows={len(actual)}", flush=True)


def _job_suite(args):
    """Real JOB queries at scale, SPMD across the process cluster.

    The BASELINE.json config-5 scenario: multi-host execution of
    hash-partitioned shuffle joins on 10x-scaled IMDB (synthetic,
    identical on every rank per the replicated-input contract of
    parallel/multihost.py — the reference has no distributed mode at
    all, SURVEY.md §2 checklist). Every rank executes the full plan
    over the global mesh; rank 0 additionally verifies each query's
    gathered rows against the sqlite oracle on the rewritten SQL and
    writes the timing record."""
    import json
    import time

    import numpy as np

    from radixjoin.harness import datagen, oracle
    from radixjoin.harness.run import JobHarness, TableSource
    from radixjoin.parallel import make_mesh, multihost

    # Initialize the cross-process (gloo) collective context while every
    # rank is still in lockstep, BEFORE the minutes-long per-rank datagen:
    # gloo's TCP pair connect has a short timeout, and any rank-asymmetric
    # work in front of the first collective trips it.
    mesh = make_mesh()
    from jax.sharding import NamedSharding, PartitionSpec

    probe = multihost.put_sharded(
        np.arange(mesh.devices.size, dtype=np.int32),
        NamedSharding(mesh, PartitionSpec(mesh.axis_names[0])),
    )
    assert multihost.fetch(probe, mesh).sum() == mesh.devices.size * (
        mesh.devices.size - 1) // 2
    print(f"[rank {args.pid}] collective context up "
          f"({mesh.devices.size} devices)", flush=True)

    from radixjoin.harness.run import DEFAULT_PLANS, load_workload

    plans_path = args.plans or DEFAULT_PLANS
    names = [q for q in args.job_queries.split(",") if q]
    _, _, queries = load_workload(plans_path)
    gen = datagen.SyntheticIMDB(scale=args.scale, seed=0, queries=queries)
    print(f"[rank {args.pid}] generating synthetic IMDB "
          f"scale {args.scale} ...", flush=True)
    source = TableSource(host_tables=gen.generate())
    harness = JobHarness(plans_path, source)
    harness.distributed = True
    harness._mesh = mesh

    per_query = {}
    results = {}
    for name in names:
        times = []
        result = None
        for _ in range(max(1, args.repeats) + 1):  # first rep = compile
            t0 = time.perf_counter()
            result, runtime_ms, _, _ = harness.run_query(name)
            times.append(round((time.perf_counter() - t0) * 1e3, 2))
        results[name] = result
        per_query[name] = {
            "best_ms": min(times[1:]),
            "times_ms": times,
            "rows": result.num_rows,
            "correct": None,
        }
        print(f"[rank {args.pid}] {name}: best {min(times[1:])} ms "
              f"rows={result.num_rows}", flush=True)

    # Verification runs AFTER the timed loop (sqlite load + queries are
    # rank-0-only work; the timed loop itself must stay rank-symmetric
    # so no collective waits on a busy peer).
    all_ok = True
    if args.pid == 0:
        print("[rank 0] loading sqlite oracle ...", flush=True)
        sqlite_oracle = oracle.SqliteOracle(source.host_tables)
        for name in names:
            parsed, _plan = harness.build_plan(name)
            actual = results[name].to_host().to_rows()
            sql_rows = sqlite_oracle.query(parsed.executed_sql())
            correct, detail = oracle.rows_equal(actual, sql_rows)
            per_query[name]["correct"] = bool(correct)
            if not correct:
                all_ok = False
                print(f"[rank 0] {name} MISMATCH: {detail}", flush=True)

    import jax

    record = {
        "scenario": "job",
        "scale": args.scale,
        "processes": jax.process_count(),
        "global_devices": jax.device_count(),
        "queries": per_query,
        "total_best_ms": round(sum(q["best_ms"] for q in per_query.values()), 2),
        "all_correct": all_ok if args.pid == 0 else None,
    }
    with open(args.out, "w") as f:
        json.dump(record, f)
    print(f"[rank {args.pid}] job suite done: {record['total_best_ms']} ms",
          flush=True)
    if args.pid == 0 and not all_ok:
        sys.exit(1)


def _bench_join(args):
    """Timed distributed shuffle join at fixed global size.

    The same global problem runs under any process decomposition of the
    mesh, so the orchestrator (tools/multihost_bench.py) can compare
    1-process x 8-device against 2-process x 4-device and report the
    process-boundary (DCN-analogue) efficiency. Skewed probe keys keep
    the hot-key broadcast path live. Rank 0 writes best-of timings."""
    import json
    import time

    import numpy as np

    from radixjoin.parallel import DistJoinConfig, make_mesh
    from radixjoin.parallel.dist_join import (
        detect_hot_keys, distributed_join_device, shard_inputs,
    )
    from radixjoin.parallel import multihost

    n_probe = args.bench_rows
    n_build = n_probe // 4
    rng = np.random.default_rng(11)  # identical on every rank
    bk = rng.permutation(n_build * 2)[:n_build].astype(np.int64)
    bv = rng.random(n_build) > 0.02
    pk = rng.integers(0, n_build * 2, n_probe).astype(np.int64)
    pk[rng.random(n_probe) < 0.10] = int(bk[0])  # one heavy hitter
    pv = rng.random(n_probe) > 0.02
    bp = {"x": rng.integers(0, 1 << 20, n_build).astype(np.int32)}
    pp = {"y": rng.integers(0, 1 << 20, n_probe).astype(np.int32)}

    mesh = make_mesh()
    config = DistJoinConfig()
    kb, vb, bpl, kp, vp, ppl = shard_inputs(mesh, bk, bv, bp, pk, pv, pp)
    ndev = mesh.devices.size
    cap_p = max(16, int(config.capacity_factor * (kp.shape[0] // ndev) / ndev) + 1)
    hot_keys, hot_valid = detect_hot_keys(pk, pv, config, ndev, cap_p)

    times = []
    total = None
    warmup = 2  # compile + runtime settle: both excluded from statistics
    for _ in range(max(1, args.repeats) + warmup):
        t0 = time.perf_counter()
        columns, live, totals = distributed_join_device(
            kb, vb, bpl, kp, vp, ppl, mesh, hot_keys, hot_valid, config
        )
        total = int(np.sum(totals))  # host array (fetched by the ladder)
        times.append((time.perf_counter() - t0) * 1e3)
    steady = times[warmup:]
    mean = sum(steady) / len(steady)
    sigma = (sum((t - mean) ** 2 for t in steady) / len(steady)) ** 0.5
    import jax

    record = {
        "scenario": "bench_join",
        "processes": jax.process_count(),
        "global_devices": jax.device_count(),
        "probe_rows": n_probe,
        "build_rows": n_build,
        "result_rows": total,
        "best_ms": round(min(steady), 2),
        "mean_ms": round(mean, 2),
        "sigma_ms": round(sigma, 2),
        "warmup_dropped": warmup,
        "times_ms": [round(t, 2) for t in times],
    }
    if args.pid == 0:
        with open(args.out, "w") as f:
            json.dump(record, f)
    else:
        with open(args.out, "w") as f:
            f.write("OK\n")
    print(f"[rank {args.pid}] bench {record}", flush=True)


if __name__ == "__main__":
    main()
