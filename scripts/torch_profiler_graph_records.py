#!/usr/bin/env python3
"""Whether `torch.profiler` keeps the kernel records of CUDA-graph replays.

Builds the port's fixed-base plan at 2^20 three times under the profiler
(device activity), then profiles one `device_affine` call (about 10^5
plain kernels, CPU and device activity), then builds the plan three times
more. Each build runs its `plan_niels_m{M}` stage four times: the first
build of the process runs it eagerly once and replays its graph thrice,
the later builds replay it four times, one `to_niels_xy_rows` kernel each.
For each build it prints the launches the counts hold, the
`to_niels_xy_rows_kernel` records the profiler kept, and whether every
batch's rows equal the eager stage's bit for bit (each batch has other
points, so a replay that did not run would leave the previous batch's).

    python3 scripts/torch_profiler_graph_records.py      (one NVIDIA GPU, nvcc)

Prints the card's name and power limit first, then one JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from webgpu_msm_tpu_torch import MSMConfig, compute_msm
    from webgpu_msm_tpu_torch.engines import gpu_engine
    from webgpu_msm_tpu_torch.ops.kernels import build
    from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
    from webgpu_msm_tpu_torch.utils import cache, convert, fixtures

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    build.load()
    dev, cfg, n = torch.device("cuda"), MSMConfig(), 1 << 20
    pw = fixtures.wire_points(fixtures.distinct_points_fast(n, seed=20))
    sw = convert.bigints_to_u32_be(fixtures.random_scalars(n, seed=1020))
    with cache.eager():
        want = gpu_engine.WirePlan(pw, cfg, dev)._rows

    def plan_build(label: str) -> dict:
        pk.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            plan = gpu_engine.WirePlan(pw, cfg, dev)
            torch.cuda.synchronize()
        kept = pk.profiled_launches(prof.events())["to_niels_xy_rows"]
        exact = all(torch.equal(a, b) for a, b in zip(plan._rows, want))
        return {"build": label, "counted": pk.launches["to_niels_xy_rows"], "profiler_kept": kept,
                "rows_exact": exact}

    rows = [plan_build(f"before {i}") for i in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        compute_msm(pw, sw, config=MSMConfig(device_affine=True), device=dev)
        torch.cuda.synchronize()
    big = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    rows += [plan_build(f"after {i}") for i in range(3)]
    print(json.dumps({"profiler_graph_records": rows, "big_profile_device_records": big,
                      "torch": torch.__version__, "cuda": torch.version.cuda, "card": smi}))
    return 0 if all(r["rows_exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
