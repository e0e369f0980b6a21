#!/usr/bin/env python
"""Distributed shuffle-join scaling bench.

Measures rows/s of :func:`radixjoin.parallel.distributed_join` at mesh
sizes 1..N and reports weak-scaling efficiency (rows per device held
constant; ideal = flat rows/s/device). It runs on the virtual CPU mesh
(``xla_force_host_platform_device_count``) — shards execute on separate
host cores, so the balance of the shuffle + local-join pipeline is what
is being measured, not device or interconnect speed. The reference has
no distributed mode (SURVEY.md §2 — single process); the >=80%
efficiency target comes from BASELINE.json's north star.

Each mesh size runs in a fresh subprocess (device count is fixed at
backend init).

Usage: python tools/scaling_bench.py [--ndev 1,2,4,8] [--rows 200000]
       [--skew 0.2] [--json out.json]
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(ndev: int, rows_per_dev: int, skew: float, reps: int,
            chunks: int = 1, breakdown: bool = False) -> dict:
    """Child-process body: build the mesh, run the join, report timings."""
    import numpy as np
    import jax

    jax.config.update("jax_platforms", "cpu")

    from radixjoin.parallel import distributed_join, make_mesh
    from radixjoin.parallel.dist_join import (
        DistJoinConfig, detect_hot_keys, distributed_join_device,
        shard_inputs, _pad_to_shards, _phase_fn,
    )

    mesh = make_mesh(ndev)
    rng = np.random.default_rng(0)
    n_probe = rows_per_dev * ndev
    n_build = max(1024, n_probe // 8)
    bk = rng.permutation(n_build * 4)[:n_build].astype(np.int64)
    bv = np.ones(n_build, bool)
    pk = rng.choice(bk, n_probe).astype(np.int64)
    n_hot = int(skew * n_probe)
    if n_hot:
        pk[:n_hot] = bk[0]  # one heavy hitter takes `skew` of the probe side
    pv = np.ones(n_probe, bool)
    bpl = {"val": (bk * 3).astype(np.int64)}
    ppl = {"row": np.arange(n_probe, dtype=np.int64)}

    # pre-shard once: the scaling measure targets the SPMD shuffle+join
    # phases (what crosses the interconnect), not host staging
    config = DistJoinConfig(exchange_chunks=chunks)
    sharded = shard_inputs(mesh, bk, bv, bpl, pk, pv, ppl)
    cap_p = max(16, int(config.capacity_factor * (sharded[3].shape[0] // ndev) / ndev) + 1)
    hot_keys, hot_valid = detect_hot_keys(
        _pad_to_shards(pk, ndev),
        _pad_to_shards(pv.astype(bool), ndev, fill=False),
        config, ndev, cap_p,
    )
    # warmup (compile) + capture the resolved static config for the
    # per-phase instrumentation below
    info: dict = {}
    cols, live, totals = distributed_join_device(
        *sharded, mesh, hot_keys, hot_valid, config, info_out=info
    )
    jax.block_until_ready(live)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        cols, live, totals = distributed_join_device(
            *sharded, mesh, hot_keys, hot_valid, config
        )
        jax.block_until_ready(live)
        times.append(time.perf_counter() - t0)
    best = min(times)
    out_rows = int(np.asarray(live).sum())
    res = {
        "ndev": ndev,
        "probe_rows": n_probe,
        "out_rows": out_rows,
        "s": best,
        "probe_rows_per_s": n_probe / best,
        "chunks": chunks,
    }
    if breakdown:
        res.update(_phase_breakdown(
            mesh, ndev, sharded, hot_keys, hot_valid, info, reps))
    return res


def _phase_breakdown(mesh, ndev, sharded, hot_keys, hot_valid,
                     info, reps) -> dict:
    """Per-phase timings (VERDICT r1 #3): the exchange phase (all_to_all
    + local co-sort + count) and the expand phase (pure local) are
    separate jitted programs in production (dist_join._phase_fn), so each
    is timed through its own full sync. A third number — the local
    co-sort+count alone, jitted WITHOUT shard_map at exactly the received
    per-device shapes — separates algorithmic compute from
    collective+padding overhead: exchange_overhead = phaseA - local.

    Also records the bytes each device sends on the wire (the padded
    all_to_all buffers minus the diagonal that stays home, plus the hot
    all_gather)."""
    import numpy as np
    import jax

    from radixjoin.ops import join as join_ops

    kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d = sharded
    bnames, pnames = tuple(bpl_d), tuple(ppl_d)
    hk, hv = np.asarray(hot_keys), np.asarray(hot_valid)
    common = dict(bloom_bits=info["bloom_bits"], chunks=info["chunks"],
                  ngroups=info["ngroups"])
    ex_fn = _lazy_phase_fn("exchange", mesh, ndev, info, bnames, pnames,
                           None, common)
    mat_fn = _lazy_phase_fn("expand", mesh, ndev, info, bnames, pnames,
                            info["s_pad"], common)
    args = (kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d, hk, hv)
    groups = ex_fn(*args)[0]
    jax.block_until_ready(groups)
    ex_ms, mat_ms = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        groups, _tot, _ovf = ex_fn(*args)
        jax.block_until_ready(groups)
        t1 = time.perf_counter()
        out = mat_fn(groups)
        jax.block_until_ready(out)
        ex_ms.append((t1 - t0) * 1e3)
        mat_ms.append((time.perf_counter() - t1) * 1e3)

    # local reference: the same co-sort+count at the received per-device
    # shapes (ndev senders x cap rows each), no shard_map, no collectives
    rng = np.random.default_rng(1)
    nb, npb = ndev * info["cap_b"], ndev * info["cap_p"]
    lkb = jax.numpy.asarray(rng.integers(0, 1 << 40, nb))
    lkp = jax.numpy.asarray(rng.integers(0, 1 << 40, npb))
    lvb = jax.numpy.ones(nb, bool)
    lvp = jax.numpy.ones(npb, bool)
    local = jax.jit(join_ops.join_merge_impl)
    jax.block_until_ready(local(lkb, lvb, lkp, lvp))
    loc_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(local(lkb, lvb, lkp, lvp))
        loc_ms.append((time.perf_counter() - t0) * 1e3)

    brow = 8 + 1 + 8 * len(bnames)  # key + valid + i64 payloads
    prow = 8 + 1 + 8 * len(pnames)
    chunks = info["chunks"]
    sent = (ndev - 1) * chunks * (info["cap_b"] * brow + info["cap_p"] * prow)
    sent += (ndev - 1) * info["hot_cap"] * brow  # hot all_gather
    sent += 2 * info["bloom_bits"] // 8  # psum-OR of the Bloom bitmap
    return {
        "phase_exchange_ms": min(ex_ms),
        "phase_expand_ms": min(mat_ms),
        "local_sort_count_ms": min(loc_ms),
        "bytes_sent_per_dev": int(sent),
        "cap_b": info["cap_b"], "cap_p": info["cap_p"],
        "hot_cap": info["hot_cap"], "s_pad": info["s_pad"],
    }


def _lazy_phase_fn(phase, mesh, ndev, info, bnames, pnames, s_pad, common):
    from radixjoin.parallel.dist_join import _phase_fn

    return _phase_fn(
        phase, mesh, ndev, info["cap_b"], info["cap_p"], info["hot_cap"],
        bnames, pnames, s_pad, **common,
    )


def run_one_plan(ndev: int, rows_per_dev: int, reps: int) -> dict:
    """Child-process body for --mode plan: a 3-join star-schema Plan runs
    end to end on the mesh via parallel.execute_distributed (whole-plan
    SPMD — intermediates never leave the devices)."""
    import numpy as np
    import jax

    jax.config.update("jax_platforms", "cpu")

    from radixjoin.dtypes import DataType
    from radixjoin.parallel import execute_distributed, make_mesh
    from radixjoin.plan.ir import Plan
    from radixjoin.storage.columnar import ColumnarTable, HostTable

    mesh = make_mesh(ndev)
    rng = np.random.default_rng(0)
    n_fact = rows_per_dev * ndev
    n_d1, n_d2 = max(256, n_fact // 16), max(64, n_fact // 64)

    def table(rows, types):
        return ColumnarTable.from_host(HostTable.from_rows(rows, types))

    plan = Plan()
    fact_rows = np.stack([
        rng.integers(0, n_d1, n_fact),
        rng.integers(0, n_d2 * 2, n_fact),  # half miss dimension 2
    ], axis=1).astype(np.int64)
    f = plan.new_scan_node(
        plan.new_input(table(fact_rows.tolist(),
                             [DataType.INT64, DataType.INT64])),
        [(0, DataType.INT64), (1, DataType.INT64)])
    d1 = plan.new_scan_node(
        plan.new_input(table([[int(k), int(k % 31)] for k in range(n_d1)],
                             [DataType.INT64, DataType.INT64])),
        [(0, DataType.INT64), (1, DataType.INT64)])
    j1 = plan.new_join_node(True, d1, f, 0, 0,
                            [(1, DataType.INT64), (3, DataType.INT64)])
    d2 = plan.new_scan_node(
        plan.new_input(table([[int(k), int(k * 7)] for k in range(n_d2)],
                             [DataType.INT64, DataType.INT64])),
        [(0, DataType.INT64), (1, DataType.INT64)])
    plan.root = plan.new_join_node(True, d2, j1, 0, 1,
                                   [(1, DataType.INT64), (2, DataType.INT64)])

    out = execute_distributed(plan, mesh=mesh)  # warmup (compiles)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = execute_distributed(plan, mesh=mesh)
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {
        "ndev": ndev,
        "probe_rows": n_fact,
        "out_rows": out.num_rows,
        "s": best,
        "probe_rows_per_s": n_fact / best,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ndev", default="1,2,4,8")
    ap.add_argument("--rows", type=int, default=200_000, help="probe rows/device")
    ap.add_argument("--skew", type=float, default=0.2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mode", choices=["join", "plan"], default="join",
                    help="join: one shuffle join; plan: whole-plan "
                         "distributed execution (3-join star schema)")
    ap.add_argument("--chunks", type=int, default=1,
                    help="exchange_chunks for --mode join (A/B the "
                         "overlap-ready chunked exchange)")
    ap.add_argument("--breakdown", action="store_true",
                    help="per-phase timings")
    ap.add_argument("--json", default=None)
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.child is not None:
        if args.mode == "plan":
            result = run_one_plan(args.child, args.rows, args.reps)
        else:
            result = run_one(args.child, args.rows, args.skew, args.reps,
                             args.chunks, args.breakdown)
        print("CHILD_RESULT " + json.dumps(result))
        return

    results = []
    for ndev in [int(x) for x in args.ndev.split(",")]:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={ndev}"
        ).strip()
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", str(ndev),
             "--rows", str(args.rows), "--skew", str(args.skew),
             "--reps", str(args.reps), "--mode", args.mode,
             "--chunks", str(args.chunks)]
            + (["--breakdown"] if args.breakdown else []),
            env=env, capture_output=True, text=True,
        )
        if proc.returncode != 0:
            print(proc.stderr[-2000:], file=sys.stderr)
            raise SystemExit(f"ndev={ndev} failed")
        line = [l for l in proc.stdout.splitlines() if l.startswith("CHILD_RESULT")]
        results.append(json.loads(line[0][len("CHILD_RESULT "):]))

    base = results[0]["probe_rows_per_s"] if results else 1.0
    print(f"NOTE: virtual CPU mesh on {os.cpu_count()} host core(s) — all "
          "'devices' share them (XLA CPU already uses every core at "
          "ndev=1), so wall-clock efficiency here reflects host "
          "saturation, not interconnect scaling. Per-device work is constant by "
          "construction (send/recv buffers are ndev x cf*L/ndev = cf*L).")
    print(f"{'ndev':>5} {'probe rows':>12} {'out rows':>10} {'ms':>9} "
          f"{'Mrows/s':>9} {'eff':>6}")
    for r in results:
        eff = r["probe_rows_per_s"] / (base * r["ndev"])
        r["weak_efficiency"] = eff
        print(f"{r['ndev']:>5} {r['probe_rows']:>12,} {r['out_rows']:>10,} "
              f"{r['s']*1e3:>9.2f} {r['probe_rows_per_s']/1e6:>9.2f} "
              f"{eff*100:>5.1f}%")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
