#!/usr/bin/env python
"""Smoke test of the join engine on one NVIDIA GPU (or four with --four).

Drives the main path through the entry points a user calls, on the
in-repo synthetic JOB-shaped workload (workloads/job_shaped), and checks
every result. Phases, in order; any failure exits non-zero and prints no
result line:

1. device  -- the card's name and power limit (nvidia-smi, read before
   JAX touches the card) and JAX's platform, device kind and count. Any
   platform but ``gpu`` fails.
2. kernels -- every gather on the device path (shared-index column
   gathers at windows of 128, 4,096 and 2^22 entries over 2^24 indices;
   the per-page gather of device page decode) against numpy, bit for bit.
3. verify  -- the workload at sf0.01 through ``JobHarness.run_query(
   verify=True)`` (the path of ``python -m radixjoin.harness.run``):
   every query must equal the row interpreter, SQLite, and the vectorized
   numpy reference; ``execute_many`` over the workload must equal the
   serial results.
4. full    -- the workload at sf1.0 (74.2M rows): each query cold, once
   more to settle learned cardinality feedback, then warm; every result
   must equal the numpy reference. Prints warm ms per query, peak device
   memory and the engine's degradation tallies, which must all be 0.

``--four`` runs only ``execute_distributed`` over a 4-device mesh on the
workload at sf0.1, compared with the numpy reference.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Run: ``python chip_smoke.py`` (one card) or ``python chip_smoke.py --four``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SEED = 0
VERIFY_SCALE = 0.01
FULL_SCALE = 1.0
FOUR_SCALE = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(count: int):
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=120,
        )
    except FileNotFoundError:
        raise SystemExit("nvidia-smi not found: no NVIDIA GPU here")
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    import jax

    devices = jax.devices()
    dev = devices[0]
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devices)}")
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev}")
    if len(devices) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {len(devices)}")
    return card, {"platform": dev.platform, "kind": dev.device_kind,
                  "count": len(devices)}


def phase_kernels(n: int = 1 << 24, windows=(128, 4096, 1 << 22),
                  decode_rows: int = (1 << 22) + 123) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from radixjoin.dtypes import DataType
    from radixjoin.ops import join as join_ops
    from radixjoin.storage import device_decode as dd

    rng = np.random.default_rng(SEED)
    gather = jax.jit(join_ops.gather_expand_multi)
    for w in windows:
        tables = [
            rng.integers(-(1 << 31), 1 << 31, w, dtype=np.int32),
            rng.integers(-(1 << 63), (1 << 63) - 1, w, dtype=np.int64),
            rng.random(w) < 0.5,
        ]
        dev_tables = [jnp.asarray(t) for t in tables]
        for order in ("random", "monotone"):
            idx = rng.integers(0, w, n, dtype=np.int32)
            if order == "monotone":
                idx.sort()
            outs = gather(dev_tables, jnp.asarray(idx))
            for t, o in zip(tables, outs):
                got = np.asarray(o)
                if got.dtype != t.dtype or not np.array_equal(got, t[idx]):
                    raise AssertionError(
                        f"gather mismatch: window {w}, {order} indices, "
                        f"{t.dtype}"
                    )
            log(f"kernels: gather window={w} {order} n={n} "
                f"i32/i64/bool exact")
    for dtype, npdt in ((DataType.INT32, np.int32), (DataType.INT64, np.int64),
                        (DataType.FP64, np.float64)):
        if npdt is np.float64:
            vals = rng.normal(size=decode_rows) * 1e6
        else:
            info = np.iinfo(npdt)
            vals = rng.integers(info.min, info.max, decode_rows, dtype=npdt)
        valid = rng.random(decode_rows) >= 0.25
        vals[~valid] = 0
        pages = dd.encode_fixed_aligned(vals, valid, dtype)
        data, dvalid = dd.decode_fixed_device(pages, decode_rows, dtype)
        data, dvalid = np.asarray(data), np.asarray(dvalid)
        want = vals.view(np.int64) if npdt is np.float64 else vals
        if not (np.array_equal(dvalid, valid)
                and np.array_equal(data, want)):
            raise AssertionError(f"device page decode mismatch: {dtype}")
        log(f"kernels: page decode {dtype.name} rows={decode_rows} exact")


def _workload(scale: float):
    from radixjoin.harness import datagen
    from radixjoin.harness.run import (
        DEFAULT_PLANS, JobHarness, TableSource, load_workload,
    )

    names, _, queries = load_workload()
    t0 = time.perf_counter()
    tables = datagen.SyntheticIMDB(
        scale=scale, seed=SEED, queries=queries
    ).generate()
    rows = sum(t.num_rows for t in tables.values())
    log(f"data: synthetic IMDB sf{scale}: {rows} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    return names, tables, JobHarness(
        DEFAULT_PLANS, TableSource(host_tables=tables)
    )


def phase_verify(scale: float = VERIFY_SCALE) -> None:
    from radixjoin import execute, execute_many
    from radixjoin.harness import oracle

    names, tables, harness = _workload(scale)
    sqlite_oracle = oracle.SqliteOracle(tables)
    serial = {}
    for name in names:
        result, ms, correct, detail = harness.run_query(
            name, verify=True, sqlite_oracle=sqlite_oracle
        )
        if not correct:
            raise AssertionError(f"verify {name}: {detail}")
        _, plan = harness.build_plan(name)
        ok, detail = oracle.tables_equal(
            result.to_host(), oracle.execute_plan_numpy(plan)
        )
        if not ok:
            raise AssertionError(f"verify {name} vs numpy reference: {detail}")
        serial[name] = execute(plan, harness.context)
        log(f"verify: {name} rows={result.num_rows} first run {ms:.1f} ms; "
            f"equals row oracle, SQLite and numpy reference")
    plans = [harness.build_plan(n)[1] for n in names]
    batch = execute_many(plans, harness.context)
    for name, b in zip(names, batch):
        ok, detail = oracle.tables_equal(b.to_host(), serial[name].to_host())
        if not ok:
            raise AssertionError(f"execute_many {name}: {detail}")
    log(f"verify: execute_many over {len(names)} queries equals serial")
    harness.close()


def phase_full(scale: float = FULL_SCALE) -> None:
    import jax

    from radixjoin import engine, execute
    from radixjoin.harness import oracle

    engine.reset_engine_stats()
    names, _tables, harness = _workload(scale)
    warm = {}
    for name in names:
        _, plan = harness.build_plan(name)
        t0 = time.perf_counter()
        expected = oracle.execute_plan_numpy(plan)
        ref_s = time.perf_counter() - t0
        times = []
        for _ in range(3):  # cold, feedback settle, warm
            t0 = time.perf_counter()
            result = execute(plan, harness.context)
            times.append((time.perf_counter() - t0) * 1e3)
            ok, detail = oracle.tables_equal(result.to_host(), expected)
            if not ok:
                raise AssertionError(f"full {name}: {detail}")
        warm[name] = times[-1]
        log(f"full: {name} rows={expected.num_rows} cold {times[0]:.1f} ms "
            f"warm {times[-1]:.2f} ms (numpy reference {ref_s:.1f} s); "
            f"equal")
    stats = engine.engine_stats()
    mem = jax.devices()[0].memory_stats() or {}
    log(f"full: warm total {sum(warm.values()):.2f} ms over {len(names)} "
        f"queries; peak_bytes_in_use={mem.get('peak_bytes_in_use')} "
        f"bytes_limit={mem.get('bytes_limit')}")
    log(f"full: engine_stats={json.dumps(stats)}")
    degraded = {k: v for k, v in stats.items() if k != "queries" and v}
    if degraded:
        raise AssertionError(f"full: degraded queries {stats}")
    harness.close()


def phase_four(scale: float = FOUR_SCALE, n_devices: int = 4) -> None:
    from radixjoin.harness import oracle
    from radixjoin.parallel import make_mesh
    from radixjoin.parallel.dist_executor import execute_distributed

    names, _tables, harness = _workload(scale)
    mesh = make_mesh(n_devices)
    for name in names:
        _, plan = harness.build_plan(name)
        expected = oracle.execute_plan_numpy(plan)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            result = execute_distributed(plan, mesh=mesh)
            times.append((time.perf_counter() - t0) * 1e3)
            ok, detail = oracle.tables_equal(result, expected)
            if not ok:
                raise AssertionError(f"four {name}: {detail}")
        log(f"four: {name} rows={expected.num_rows} over {n_devices} "
            f"devices: first {times[0]:.1f} ms, repeat {times[1]:.1f} ms; "
            f"equals numpy reference")
    harness.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only execute_distributed over 4 GPUs")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import radixjoin  # noqa: F401  (fails outside a checkout of the repo)

    card, device = phase_device(4 if args.four else 1)

    from radixjoin.harness.run import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    if args.four:
        phase_four()
    else:
        phase_kernels()
        phase_verify()
        phase_full()
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    log(card)  # nvidia-smi: name, power.limit
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
