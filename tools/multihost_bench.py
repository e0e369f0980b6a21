"""Multi-host scaling-efficiency measurement (SURVEY.md §7 step 6).

Runs the identical global shuffle-join problem under two decompositions
of the same 8-device CPU mesh:

- 1 process x 8 devices (every collective stays in-process), and
- 2 processes x 4 devices (half the all-to-all lanes cross a process
  boundary over gloo/TCP, as they would between hosts).

Efficiency = t(1 proc) / t(2 procs) for constant global work: the
fraction of single-controller throughput that survives the process
boundary. Writes the record to ``--out`` when given.

Usage: python tools/multihost_bench.py [--rows N] [--repeats R]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_cluster(nprocs: int, local_devices: int, rows: int, repeats: int,
                scenario: str = "bench_join", extra_args=(),
                timeout_s: float = 1800):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    with tempfile.TemporaryDirectory() as td:
        outs = [os.path.join(td, f"rank{p}.json") for p in range(nprocs)]
        procs = [
            subprocess.Popen(
                [sys.executable, WORKER, "--pid", str(p),
                 "--nprocs", str(nprocs), "--port", str(port),
                 "--local-devices", str(local_devices),
                 "--out", outs[p], "--scenario", scenario,
                 "--bench-rows", str(rows), "--repeats", str(repeats),
                 *extra_args],
                env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
            for p in range(nprocs)
        ]
        # Poll all ranks: if any rank dies (e.g. an init error before it
        # joins the cluster) the survivors hang in collectives forever —
        # kill the whole group and surface the FAILED rank's log, not a
        # 30-minute TimeoutExpired with no diagnostics.
        import time as _time

        deadline = _time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if _time.monotonic() > deadline:
                for p in procs:
                    p.kill()
                raise RuntimeError(
                    f"multihost bench timed out ({timeout_s:.0f} s)")
            _time.sleep(0.5)
        failed = [p for p in procs if p.poll() not in (None, 0)]
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        logs = [p.communicate()[0] for p in procs]
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(
                    f"worker rank {rank} failed "
                    f"(exit {p.returncode}):\n{log[-3000:]}"
                )
        with open(outs[0]) as f:
            return json.load(f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 21)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--job", action="store_true",
                    help="run the in-repo workload's queries at --scale "
                         "through the 2-process cluster instead of the "
                         "synthetic join")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--queries", default="s1,s3,s8,s16")
    args = ap.parse_args()

    if args.job:
        extra = ["--scale", str(args.scale), "--job-queries", args.queries]
        rec = run_cluster(2, 4, 0, args.repeats, scenario="job",
                          extra_args=extra, timeout_s=7200)
        rec["description"] = (
            "workload queries executed SPMD over a 2-process x 4-device "
            "CPU mesh (gloo cross-process collectives) on synthetic IMDB "
            f"at scale {args.scale}; rank-0 results verified vs the sqlite "
            "oracle"
        )
        print(json.dumps(rec, indent=2), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rec, f, indent=2)
        return

    decomps = {}
    for nprocs, local in [(1, 8), (2, 4), (4, 2)]:
        rec = run_cluster(nprocs, local, args.rows, args.repeats)
        decomps[nprocs] = rec
        print(f"{nprocs} proc x {local} dev: mean {rec['mean_ms']} "
              f"± {rec['sigma_ms']} ms (best {rec['best_ms']}, "
              f"{rec['result_rows']} rows)", flush=True)
    rows = {r["result_rows"] for r in decomps.values()}
    assert len(rows) == 1, f"results differ across decompositions: {rows}"

    single = decomps[1]
    record = {
        "description": (
            "same global shuffle join under 1x8 / 2x4 / 4x2 process "
            "decompositions of an 8-device CPU mesh (gloo cross-process "
            "collectives). "
            "mean ± sigma over steady-state iterations (2 warmup "
            "iterations dropped: compile + runtime settle)"
        ),
        "probe_rows": single["probe_rows"],
        "build_rows": single["build_rows"],
        "result_rows": single["result_rows"],
        "cross_process_efficiency": {
            str(np): round(single["mean_ms"] / decomps[np]["mean_ms"], 3)
            for np in decomps
        },
        "decompositions": {str(np): decomps[np] for np in decomps},
    }
    print(f"cross-process efficiency: "
          f"{record['cross_process_efficiency']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)


if __name__ == "__main__":
    main()
