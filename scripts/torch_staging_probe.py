#!/usr/bin/env python3
"""Time the GPU engine's staging writer, the native row copier
(`webgpu_msm_tpu_torch/runtime/rows.py`), against numpy's `copyto` on the
host of one NVIDIA GPU.

    python3 scripts/torch_staging_probe.py [--out FILE]     (one NVIDIA GPU, g++)

For each layout (x||y: the first 16 words of [n, 32] u32 point rows;
scalars: [n, 8] u32 rows whole) and n = 2^14 .. 2^20 rows, it writes into
pinned memory from four rotating source sets (so the source is not in
cache) with numpy's `copyto`, the copier alone and the copier with its
pool, each idle and with a host-to-device copy of another pinned buffer of
the same size in flight (as when batch b + 1 is written while batch b is
copied). Prints the median, 90th percentile and largest write (ms) and the
rate at the median (GB/s of destination bytes, as `stage_gbps` counts),
then the copier with the pool and alone at 2, 4 and all of the host's CPUs
(child processes with a narrower CPU affinity; plain memory, idle), and
one JSON line with every row (also written to FILE).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

LAYOUTS = {"xy": (32, 16), "scalars": (8, 8)}  # source words a row, words copied
SETS = 4


def reps(n: int) -> int:
    return 41 if n <= 1 << 17 else 21


def sources(n: int, src_words: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2**32, size=(n, src_words), dtype=np.uint32) for _ in range(SETS)]


def writers(rows_mod):
    return {
        "numpy": lambda dst, src: np.copyto(dst, src[:, : dst.shape[1]]),
        "alone": lambda dst, src: rows_mod.copy_rows(dst, src, _parallel=False),
        "pool": lambda dst, src: rows_mod.copy_rows(dst, src, _parallel=True),
    }


def stats(times_ms: list, dst_bytes: int) -> dict:
    q = statistics.quantiles(times_ms, n=10)
    med = statistics.median(times_ms)
    return {"median_ms": med, "p90_ms": q[8], "max_ms": max(times_ms), "gbps": dst_bytes / med / 1e6}


def child(cpus: int) -> int:
    """Plain memory, idle: the copier at 2^18 and 2^20 x||y rows with the
    process's affinity cut to `cpus` CPUs before the pool is made."""
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:cpus])
    from webgpu_msm_tpu_torch.runtime import rows

    out = []
    for log_n in (18, 20):
        n = 1 << log_n
        srcs = sources(n, 32, log_n)
        dst = np.empty((n, 16), np.uint32)
        for mode, fn in writers(rows).items():
            if mode == "numpy":
                continue
            times = []
            for r in range(reps(n)):
                t0 = time.perf_counter()
                fn(dst, srcs[r % SETS])
                times.append((time.perf_counter() - t0) * 1e3)
            assert np.array_equal(dst, srcs[(reps(n) - 1) % SETS][:, :16])
            out.append({"cpus": cpus, "workers": rows.workers(), "layout": "xy", "log_n": log_n,
                        "mode": mode, **stats(times, n * 64)})
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    from webgpu_msm_tpu_torch.runtime import rows

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with open("/proc/cpuinfo") as f:
        cpu = next((line.split(":", 1)[1].strip() for line in f if line.startswith("model name")), "?")
    host_cpus = len(os.sched_getaffinity(0))
    print(f"card: {smi}; host: {cpu}, {host_cpus} CPUs; copier workers {rows.workers()}; "
          f"PARALLEL_ROWS {rows.PARALLEL_ROWS}")
    dev = torch.device("cuda")
    table = []
    for layout, (src_words, words) in LAYOUTS.items():
        for log_n in range(14, 21):
            n = 1 << log_n
            srcs = sources(n, src_words, log_n)
            dst_t = torch.empty((n, words), dtype=torch.int32, pin_memory=True)
            other = torch.empty((n, words), dtype=torch.int32, pin_memory=True)
            on_dev = torch.empty((n, words), dtype=torch.int32, device=dev)
            dst = dst_t.numpy().view(np.uint32)
            for mode, fn in writers(rows).items():
                for flight in (False, True):
                    times = []
                    for r in range(reps(n) + 2):  # two warm writes, not counted
                        torch.cuda.synchronize()
                        if flight:
                            on_dev.copy_(other, non_blocking=True)
                        t0 = time.perf_counter()
                        fn(dst, srcs[r % SETS])
                        t1 = time.perf_counter()
                        torch.cuda.synchronize()
                        if r >= 2:
                            times.append((t1 - t0) * 1e3)
                    if not np.array_equal(dst, srcs[(reps(n) + 1) % SETS][:, :words]):
                        raise RuntimeError(f"{mode} wrote other bytes than the source's ({layout}, 2^{log_n})")
                    row = {"layout": layout, "log_n": log_n, "mode": mode, "in_flight": flight,
                           **stats(times, n * words * 4)}
                    table.append(row)
                    print(f"{layout:8s} 2^{log_n} {mode:6s} {'copy in flight' if flight else 'idle':14s} "
                          f"median {row['median_ms']:8.3f} ms  p90 {row['p90_ms']:8.3f}  "
                          f"max {row['max_ms']:8.3f}  {row['gbps']:6.2f} GB/s", flush=True)
            del dst_t, other, on_dev, srcs
    sweep = []
    for cpus in sorted({2, 4, host_cpus}):
        if cpus > host_cpus:
            continue
        got = subprocess.run([sys.executable, __file__, "--child", str(cpus)], capture_output=True,
                             text=True, check=True, timeout=600).stdout.strip().splitlines()[-1]
        for row in json.loads(got):
            sweep.append(row)
            print(f"cpus {cpus} (workers {row['workers']}) xy 2^{row['log_n']} {row['mode']:6s} plain "
                  f"memory: median {row['median_ms']:8.3f} ms  p90 {row['p90_ms']:8.3f}  "
                  f"max {row['max_ms']:8.3f}  {row['gbps']:6.2f} GB/s", flush=True)
    line = json.dumps({"card": smi, "host_cpu": cpu, "host_cpus": host_cpus, "pinned": table,
                       "cpu_sweep": sweep})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
