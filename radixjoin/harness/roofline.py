"""Per-kernel roofline harness.

The reference ships only an external profiler wrapper (``benchmark.sh``
perf + flamegraphs); its engine publishes no kernel-level throughput
numbers. This harness measures every hot kernel in rows/s and effective
GB/s against the device's published peak memory bandwidth
(:mod:`radixjoin.hardware`; a device missing from its table is an
error).

Methodology
-----------
Join kernels do no matmuls, so they live on the memory-bound side of the
roofline: speed of light is ``hbm_gbps``. For each kernel we report

  * ``rows_per_s``  — probe-side (or total) rows processed per second;
  * ``eff_gbps``    — *algorithmic-minimum* bytes moved / time. This is
    the bytes a perfect implementation must touch (each input element
    read once, each output written once). Sort-based kernels do several
    physical passes, so their ``pct_roofline`` honestly shows the
    multiplier being paid for data-parallel shapes;
  * ``pct_roofline`` — eff_gbps / the device's peak GB/s.

Timings are medians over ``reps`` runs after a compile warmup, with
``jax.block_until_ready`` fencing (device dispatch is async).

Run: ``python -m radixjoin.harness.roofline [--size N] [--json PATH]``
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .. import hardware
from ..ops import join as join_ops


@dataclasses.dataclass
class Measurement:
    kernel: str
    rows: int
    ms: float
    rows_per_s: float
    min_bytes: int
    eff_gbps: float
    pct_roofline: float

    def row(self) -> str:
        return (
            f"{self.kernel:<28} {self.rows:>12,} {self.ms:>9.3f} "
            f"{self.rows_per_s/1e9:>8.3f}G {self.eff_gbps:>8.1f} "
            f"{self.pct_roofline*100:>6.1f}%"
        )


_CHAIN = 16


def _time(fn: Callable, args, reps: int = 5) -> float:
    """Median per-call ms, measured PIPELINED: ``_CHAIN`` back-to-back
    dispatches with one fence at the end, so the host's dispatch and sync
    cost is amortized to 1/_CHAIN per call — the same regime the engine
    runs in (async chains, one fetch per query).
    """
    jax.block_until_ready(fn(*args))  # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(_CHAIN)]
        jax.block_until_ready(outs)
        times.append((time.perf_counter() - t0) / _CHAIN)
    return float(np.median(times) * 1e3)


def _measure(name, rows, ms, min_bytes, spec) -> Measurement:
    eff = min_bytes / (ms * 1e-3) / 1e9
    return Measurement(
        name, rows, ms, rows / (ms * 1e-3), min_bytes, eff, eff / spec.hbm_gbps
    )


# ---------------------------------------------------------------------------
# Kernel cases
# ---------------------------------------------------------------------------


def bench_join_count(n: int, spec, reps: int, dtype=jnp.int32) -> Measurement:
    """Sort build + double searchsorted: the count phase of every join."""
    rng = np.random.default_rng(0)
    b = n // 4
    bk = jnp.asarray(rng.integers(0, b, b).astype(dtype))
    bv = jnp.ones(b, bool)
    pk = jnp.asarray(rng.integers(0, b, n).astype(dtype))
    pv = jnp.ones(n, bool)
    fn = jax.jit(join_ops.join_count_impl)
    ms = _time(fn, (bk, bv, pk, pv), reps)
    esize = np.dtype(dtype).itemsize
    # minimum: read both key arrays, write lo/counts/offsets (int64)
    min_bytes = (b + n) * (esize + 1) + n * 8 * 2
    return _measure(f"join_count[{np.dtype(dtype).name}]", n, ms, min_bytes, spec)


def bench_join_expand(n: int, spec, reps: int) -> Measurement:
    """Duplicate-run expansion (scatter-max + running max + gathers)."""
    rng = np.random.default_rng(0)
    b = n // 4
    bk = jnp.asarray(rng.integers(0, b, b).astype(np.int32))
    bv = jnp.ones(b, bool)
    pk = jnp.asarray(rng.integers(0, b, n).astype(np.int32))
    pv = jnp.ones(n, bool)
    perm, lo, _c, offsets, total = jax.jit(join_ops.join_count_impl)(bk, bv, pk, pv)
    s_pad = join_ops.bucket_size(int(total))
    fn = jax.jit(join_ops.join_expand_impl, static_argnames=("s_pad",))
    ms = _time(lambda *a: fn(*a, s_pad=s_pad), (perm, lo, offsets, total), reps)
    out_rows = int(total)
    min_bytes = n * 8 * 2 + out_rows * 4 * 2  # offsets/lo in, bidx/pidx out
    return _measure("join_expand", out_rows, ms, min_bytes, spec)


def bench_gather(n: int, spec, reps: int) -> Measurement:
    """Late materialization: payload gather at join-output indices."""
    rng = np.random.default_rng(0)
    vals = jnp.asarray(rng.integers(0, 1 << 30, n).astype(np.int64))
    valid = jnp.ones(n, bool)
    idx = jnp.asarray(rng.integers(0, n, n).astype(np.int32))
    live = jnp.ones(n, bool)
    fn = jax.jit(
        lambda v, m, i, l: join_ops.gather_columns([(v, m)], i, l)
    )
    ms = _time(fn, (vals, valid, idx, live), reps)
    min_bytes = n * (8 + 1 + 4) + n * (8 + 1)
    return _measure("gather_payload[i64]", n, ms, min_bytes, spec)


def bench_hash(n: int, spec, reps: int) -> Measurement:
    """64-bit avalanche hash of a key column (partitioning front end)."""
    from ..ops import hashing

    rng = np.random.default_rng(0)
    keys = jnp.asarray(rng.integers(0, 1 << 31, n).astype(np.int64))
    fn = jax.jit(hashing.murmur64)
    ms = _time(fn, (keys,), reps)
    min_bytes = n * 8 * 2
    return _measure("murmur64", n, ms, min_bytes, spec)


def bench_sort(n: int, spec, reps: int) -> Measurement:
    """Raw lax.sort throughput — the primitive under count/partition."""
    rng = np.random.default_rng(0)
    keys = jnp.asarray(rng.integers(0, 1 << 31, n).astype(np.int32))
    iota = jnp.arange(n, dtype=jnp.int32)
    fn = jax.jit(lambda k, i: jax.lax.sort((k, i), num_keys=1))
    ms = _time(fn, (keys, iota), reps)
    min_bytes = n * 4 * 4
    return _measure("sort_kv[i32]", n, ms, min_bytes, spec)


def bench_fused_join(n: int, spec, reps: int) -> Measurement:
    """End-to-end single join: count + expand + 2-column materialize."""
    rng = np.random.default_rng(0)
    b = n // 4
    bk = jnp.asarray(rng.integers(0, b, b).astype(np.int32))
    bv = jnp.ones(b, bool)
    pk = jnp.asarray(rng.integers(0, b, n).astype(np.int32))
    pv = jnp.ones(n, bool)
    bpay = jnp.asarray(rng.integers(0, 1 << 30, b).astype(np.int64))
    ppay = jnp.asarray(rng.integers(0, 1 << 30, n).astype(np.int64))
    _p, _l, _c, _o, total = jax.jit(join_ops.join_count_impl)(bk, bv, pk, pv)
    s_pad = join_ops.bucket_size(int(total))

    @jax.jit
    def fused(bk, bv, pk, pv, bpay, ppay):
        perm, lo, _c, offsets, total = join_ops.join_count_impl(bk, bv, pk, pv)
        bidx, pidx, live = join_ops.join_expand_impl(perm, lo, offsets, total, s_pad)
        return bpay[bidx], ppay[pidx], live

    ms = _time(fused, (bk, bv, pk, pv, bpay, ppay), reps)
    out_rows = int(total)
    min_bytes = (b + n) * (4 + 1 + 8) + out_rows * (8 + 8 + 1)
    return _measure("fused_join_e2e", out_rows, ms, min_bytes, spec)



def bench_join_merge(n: int, spec, reps: int, dtype=jnp.int32) -> Measurement:
    """Single-sort merge-join count (the production general-join kernel)."""
    rng = np.random.default_rng(0)
    b = n // 4
    bk = jnp.asarray(rng.integers(0, b, b).astype(dtype))
    bv = jnp.ones(b, bool)
    pk = jnp.asarray(rng.integers(0, b, n).astype(dtype))
    pv = jnp.ones(n, bool)
    fn = jax.jit(join_ops.join_merge_impl)
    ms = _time(fn, (bk, bv, pk, pv), reps)
    esize = np.dtype(dtype).itemsize
    min_bytes = (b + n) * (esize + 1) + n * 8 * 2
    return _measure(f"join_merge[{np.dtype(dtype).name}]", n, ms, min_bytes, spec)


CASES: Dict[str, Callable] = {
    "sort": bench_sort,
    "hash": bench_hash,
    "join_merge": bench_join_merge,
    "join_count": bench_join_count,
    "join_expand": bench_join_expand,
    "gather": bench_gather,
    "fused_join": bench_fused_join,
}


def run(
    size: int = 1 << 22,
    reps: int = 5,
    cases: Optional[List[str]] = None,
    spec: Optional[hardware.DeviceSpec] = None,
) -> List[Measurement]:
    spec = spec or hardware.spec()
    results = []
    for name in cases or list(CASES):
        results.append(CASES[name](size, spec, reps))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=1 << 22, help="probe rows")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cases", type=str, default=None, help="comma list")
    ap.add_argument("--json", type=str, default=None, help="write JSON here")
    args = ap.parse_args(argv)

    spec = hardware.spec()
    print(f"device: {spec.kind}  peak {spec.hbm_gbps:.0f} GB/s "
          f"({spec.source})")
    cases = args.cases.split(",") if args.cases else None
    results = run(args.size, args.reps, cases, spec)
    print(f"{'kernel':<28} {'rows':>12} {'ms':>9} {'rows/s':>9} "
          f"{'GB/s':>8} {'%roof':>7}")
    for m in results:
        print(m.row())
    if args.json:
        with open(args.json, "w") as f:
            json.dump([dataclasses.asdict(m) for m in results], f, indent=2)


if __name__ == "__main__":
    main()
