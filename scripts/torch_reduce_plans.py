#!/usr/bin/env python3
"""`reduce_finish` of the tree it is run from under forced plans: for each
(M blocks a window, lanes a block) that fits the shape, the kernel against
its plain version (every digit) and its time a launch, eager and inside a
CUDA graph, at the three shapes of the 2^20 paths and at one window of 129
and of 1 groups. The plan the wrapper picks is timed as "default". This is
how `padd_kernels._finish_plan` was chosen.

    python3 scripts/torch_reduce_plans.py   (one NVIDIA GPU, nvcc)

Inputs are seeded random residues (torch.Generator, seed 3): the digits of
kernel and plain version are compared, not points. Prints one JSON line a
(shape, plan) and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

SHAPES = ((20, 129, 5), (16, 1025, 5), (16, 8200, 2), (1, 1, 0), (1, 129, 5))
# (M, lanes a block) that the kernel takes: at most 8 blocks a window (a
# portable cluster), at most 32 lanes (256 threads) a block, and 4 M lanes
# or more where M > 1 (its launch refuses other plans).
PLANS = ((1, 16), (1, 32), (2, 16), (2, 32), (4, 16), (4, 32), (8, 32))
REPS = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    from webgpu_msm_tpu_torch.ops.kernels import build
    from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    build.load()
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def planes(width: int) -> torch.Tensor:
        d = torch.randint(0, 1 << 16, (4, 16, width), generator=gen, dtype=torch.int32)
        d[:, 15] = torch.randint(0, 0x12AB, (4, width), generator=gen, dtype=torch.int32)  # below p
        return d.to(dev)

    def event_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    default_plan = pk._finish_plan
    try:
        for K, G, d in SHAPES:
            T, U = planes(K * G), planes(K * G)
            launch = lambda: pk.reduce_finish(T, U, K, d)

            def launches():
                for _ in range(REPS):
                    launch()

            for plan in [p for p in PLANS if p[0] * p[1] <= G] + [None]:
                pk._finish_plan = default_plan if plan is None else (lambda _G, p=plan: p)
                equal = all(torch.equal(a, b) for a, b in zip(launch(), pk.reduce_finish_plain(T, U, K, d)))
                eager = event_ms(launches) / REPS
                graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
                with torch.cuda.stream(stream):
                    launch()
                    torch.cuda.synchronize()
                    with torch.cuda.graph(graph, stream=stream):
                        launches()
                replayed = event_ms(graph.replay) / REPS
                print(json.dumps({"K": K, "G": G, "doublings": d,
                                  "plan": plan or ["default", list(default_plan(G))],
                                  "equal": equal, "eager_ms": eager, "graph_ms": replayed}), flush=True)
                if not equal:
                    return 1
    finally:
        pk._finish_plan = default_plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
