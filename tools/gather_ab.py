#!/usr/bin/env python
"""Gather A/B on the GPU: XLA's gather against the hand-written candidates.

The engine's lookups are plain XLA gathers (``table[idx]``). This tool
times them on the card at the sizes the workload produces and against the
alternatives that would replace them:

* ``xla``      -- ``table[idx]`` for i32 tables of 128 to 2^22 entries and
  2^16 to 2^25 indices, random and sorted (monotone) index order;
* ``triton``   -- a Pallas kernel on the Triton route: one block per 1,024
  probes, the whole (<= 4,096-entry) table one block, read by pointer
  gather (served from L1/L2);
* ``stacked`` vs ``separate`` -- K equal-length tables gathered by one
  index stream as one (K, N) gather or as K gathers.

Every case is checked against numpy before it is timed. Times are host
wall clock around pipelined dispatches (``--reps`` calls, one
``block_until_ready``), median of ``--trials``.

Run: ``python tools/gather_ab.py [--json chiprun_out/gather_ab.json]``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import radixjoin  # noqa: E402,F401  (enables x64 like the engine)

BLOCK = 1024


def triton_window_gather(table, idx):
    """``table[idx]`` as a Pallas-Triton kernel (candidate)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    w, n = table.shape[0], idx.shape[0]

    def kernel(t_ref, i_ref, o_ref):
        o_ref[...] = t_ref[i_ref[...]]

    return pl.pallas_call(
        kernel,
        grid=(n // BLOCK,),
        in_specs=[pl.BlockSpec((w,), lambda i: (0,)),
                  pl.BlockSpec((BLOCK,), lambda i: (i,))],
        out_specs=pl.BlockSpec((BLOCK,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n,), table.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
    )(table, idx)


def _time_ms(fn, args, reps, trials):
    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(*args)
        jax.block_until_ready(r)
        out.append((time.perf_counter() - t0) * 1e3 / reps)
    return float(np.median(out))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    dev = jax.devices()[0]
    print(f"card: {smi.stdout.strip()}  jax: {dev.platform} "
          f"{dev.device_kind}", flush=True)
    rng = np.random.default_rng(0)
    rows = []
    take = jax.jit(lambda t, i: t[i])
    tri = jax.jit(triton_window_gather)

    def record(**kw):
        rows.append(kw)
        print(json.dumps(kw), flush=True)

    for w in (128, 4096, 1 << 20, 1 << 22):
        table = rng.integers(-(1 << 31), 1 << 31, w, dtype=np.int32)
        t_dev = jnp.asarray(table)
        for logn in (16, 20, 24, 25):
            n = 1 << logn
            for order in ("random", "monotone"):
                if order == "monotone" and w <= 4096:
                    continue
                idx = rng.integers(0, w, n, dtype=np.int32)
                if order == "monotone":
                    idx.sort()
                i_dev = jnp.asarray(idx)
                impls = [("xla", take)]
                if w <= 4096:
                    impls.append(("triton", tri))
                for name, fn in impls:
                    got = np.asarray(fn(t_dev, i_dev))
                    if not np.array_equal(got, table[idx]):
                        raise AssertionError(f"{name} w={w} n={n} mismatch")
                    ms = _time_ms(fn, (t_dev, i_dev), args.reps, args.trials)
                    record(case="gather", impl=name, window=w, n=n,
                           order=order, ms=round(ms, 4),
                           grows_per_s=round(n / ms / 1e6, 2))

    k = 3
    for logn in (22, 24):
        n = 1 << logn
        tables = [jnp.asarray(rng.integers(0, 1 << 30, n, dtype=np.int32))
                  for _ in range(k)]
        idx = jnp.asarray(rng.integers(0, n, n, dtype=np.int32))
        sep = jax.jit(lambda ts, i: [t[i] for t in ts])
        stk = jax.jit(lambda ts, i: list(jnp.stack(ts)[:, i]))
        for name, fn in (("separate", sep), ("stacked", stk)):
            ms = _time_ms(fn, (tables, idx), args.reps, args.trials)
            record(case="multi_gather", impl=name, tables=k, n=n,
                   ms=round(ms, 4))

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi.stdout.strip(),
                       "device_kind": dev.device_kind, "rows": rows},
                      f, indent=1)


if __name__ == "__main__":
    main()
