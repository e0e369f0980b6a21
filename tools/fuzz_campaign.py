#!/usr/bin/env python
"""Extended offline fuzz campaign over randomized join plans.

Runs the generator from tests/test_fuzz_plans.py at campaign scale:
each seed's plan is executed in every engine mode (fused / shape-shared
/ stepwise), under the forced out-of-HBM spill path, and distributed
over the 8-device CPU mesh, with every result compared exactly against
the row-semantics oracle. Seeds are chunked across subprocesses because
the CPU backend's LLVM JIT exhausts vm.max_map_count past a few hundred
distinct programs in one process.

Usage: python tools/fuzz_campaign.py [--seeds 500] [--start 0]
       [--chunk 40] [--modes auto,shared,stepwise,spill,dist]

Exit 0 = all seeds clean; failures are printed with their seed + mode
for replay (python tools/fuzz_campaign.py --seeds 1 --start <seed>).
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_chunk(start: int, count: int, modes: str) -> int:
    """Child body: fuzz seeds [start, start+count) in this process."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))

    import numpy as np

    from radixjoin import build_context, destroy_context, execute
    from radixjoin.harness.oracle import execute_plan_rows, rows_equal
    from test_fuzz_plans import _mask_nan, gen_plan

    mode_list = [m for m in modes.split(",") if m]
    failures = 0
    for seed in range(start, start + count):
        rng = np.random.default_rng(seed)
        plan = gen_plan(rng)
        expected = _mask_nan(execute_plan_rows(plan))

        def check(label, run):
            nonlocal failures
            try:
                actual_rows = run()
            except Exception as e:  # a crash is a failure, not a campaign abort
                failures += 1
                print(f"FAIL seed={seed} mode={label}: "
                      f"{type(e).__name__}: {e}", flush=True)
                return
            ok, msg = rows_equal(_mask_nan(actual_rows), expected)
            if not ok:
                failures += 1
                print(f"FAIL seed={seed} mode={label}: {msg}", flush=True)

        for mode in mode_list:
            env_mode = mode
            budget = None
            if mode == "spill":
                env_mode, budget = "auto", "4096"
            if mode in ("dist", "dist_chunked"):
                from radixjoin.parallel import DistJoinConfig, make_mesh
                from radixjoin.parallel.dist_executor import (
                    execute_distributed,
                )

                # chunked: overlap-ready exchange + minimum-size Bloom
                # (maximum false-positive pressure on the semi-join filter)
                cfg = (DistJoinConfig(exchange_chunks=3, bloom_max_bits=8192)
                       if mode == "dist_chunked" else None)
                # one mesh for both runs (feedback + phase caches key on
                # the mesh identity); cold AND warm results each go
                # through the oracle — the second run replays sync-free
                # from the first's learned feedback
                mesh_d = make_mesh()
                check(mode + "_cold", lambda: execute_distributed(
                    plan, mesh=mesh_d, config=cfg).to_rows())
                check(mode, lambda: execute_distributed(
                    plan, mesh=mesh_d, config=cfg).to_rows())
                continue
            os.environ["RJT_EXEC_MODE"] = env_mode
            if budget is not None:
                os.environ["RJT_HBM_BUDGET_BYTES"] = budget
            else:
                os.environ.pop("RJT_HBM_BUDGET_BYTES", None)

            def run_engine():
                ctx = build_context()
                try:
                    return execute(plan, ctx).to_host().to_rows()
                finally:
                    destroy_context(ctx)

            check(mode, run_engine)
    print(f"chunk [{start}, {start + count}): "
          f"{'CLEAN' if failures == 0 else f'{failures} FAILURES'}",
          flush=True)
    return 1 if failures else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=500)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=40)
    ap.add_argument("--modes", default="auto,shared,stepwise,spill,dist")
    ap.add_argument("--_child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args._child:
        sys.exit(run_chunk(args.start, args.seeds, args.modes))

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    bad = []
    done = 0
    for start in range(args.start, args.start + args.seeds, args.chunk):
        count = min(args.chunk, args.start + args.seeds - start)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--_child",
             "--start", str(start), "--seeds", str(count),
             "--modes", args.modes],
            env=env, cwd=REPO,
        )
        done += count
        if r.returncode != 0:
            bad.append(start)
        print(f"progress: {done}/{args.seeds} seeds "
              f"({len(bad)} failing chunks)", flush=True)
    if bad:
        print(f"FAILING CHUNKS at starts: {bad}")
        sys.exit(1)
    print(f"campaign clean: {args.seeds} seeds x [{args.modes}]")


if __name__ == "__main__":
    main()
