#!/usr/bin/env python3
"""The warm 2^20 wire call and plan job of the port in whatever tree it is
run from: wall times, the wire call's host dispatch time (the host's clock
until `gpu_engine._dispatch_wire` has queued the whole call, without a
sync), device busy time and device launches.

    python3 scripts/torch_wire_timing.py [label]      (one NVIDIA GPU, nvcc)

For comparing two trees on one card, run it from the root of each in turns
on the same machine (parent, change, change, parent): a call's wall time
depends on the host as much as on the card. The package is imported from
the working directory, so this file may time another tree than its own. Inputs are the pinned 2^20 case
(`distinct_points_fast(2^20, seed=20)`, `random_scalars(2^20, seed=1020)`),
and every result must equal `PINNED[20]`. Prints one JSON line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from webgpu_msm_tpu_torch import MSMConfig, MSMPlan, compute_msm
    from webgpu_msm_tpu_torch.engines import gpu_engine
    from webgpu_msm_tpu_torch.oracle.pinned_vectors import PINNED
    from webgpu_msm_tpu_torch.utils import convert, fixtures

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    n = 1 << 20
    points = fixtures.distinct_points_fast(n, seed=20)
    pts = fixtures.wire_points(points)
    sc = convert.bigints_to_u32_be(fixtures.random_scalars(n, seed=1020))
    cfg, dev = MSMConfig(), torch.device("cuda")

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        if (res.x, res.y) != PINNED[20]:
            raise RuntimeError("result differs from PINNED[20]")
        return (time.perf_counter() - t0) * 1e3

    def dispatch_and_wall(fn) -> tuple[float, float]:
        """(host ms until `_dispatch_wire` returned, wall ms) of one call."""
        marks = []
        dispatch = gpu_engine._dispatch_wire

        def marked(*args):
            out = dispatch(*args)
            marks.append(time.perf_counter())
            return out

        gpu_engine._dispatch_wire = marked
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wall_ms = timed(fn)
        finally:
            gpu_engine._dispatch_wire = dispatch
        return (marks[0] - t0) * 1e3, wall_ms

    def device_side(fn) -> tuple[float, int]:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return sum(e.self_device_time_total for e in events) / 1e3, sum(e.count for e in events)

    wire = lambda: compute_msm(pts, sc, config=cfg, device=dev)
    cold_ms = timed(wire)  # builds the kernels too
    dispatch_ms, wire_ms = zip(*(dispatch_and_wall(wire) for _ in range(5)))
    wire_busy_ms, wire_launches = device_side(wire)
    plan = MSMPlan(pts, config=cfg, device=dev)
    job = lambda: plan.msm(sc)
    timed(job)
    job_ms = [timed(job) for _ in range(5)]
    job_busy_ms, job_launches = device_side(job)
    print(json.dumps({
        "label": sys.argv[1] if len(sys.argv) > 1 else "", "card": smi,
        "first_call_with_build_ms": cold_ms,
        "wire_warm_ms": wire_ms, "wire_warm_median_ms": statistics.median(wire_ms),
        "wire_host_dispatch_ms": dispatch_ms,
        "wire_host_dispatch_median_ms": statistics.median(dispatch_ms),
        "wire_device_busy_ms": wire_busy_ms, "wire_device_launches": wire_launches,
        "plan_job_ms": job_ms, "plan_job_median_ms": statistics.median(job_ms),
        "plan_job_device_busy_ms": job_busy_ms, "plan_job_device_launches": job_launches,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
