#!/usr/bin/env python3
"""`reduce_finish` of the port in whatever tree it is run from: CUDA-event
time a launch at the three shapes the 2^20 paths give it, with the
kernel's ptxas line and the card's name and power limit.

    python3 scripts/torch_reduce_timing.py [label] [--rounds N] [--reps N]   (one NVIDIA GPU, nvcc)

Shapes (T, U [4, 16, K * G], window sums 2^d * sum g T_g + sum U_g): the
wire call's (w 13 signed, Gs 32: K 20, G 129, d 5), the resident call's (w 16
signed, Gs 32: K 16, G 1 025, d 5) and `reduce_buckets(group_size=4)` on the
resident buckets (K 16, G 8 200, d 2). T and U are distinct curve points
(`utils/fixtures.distinct_points_fast`, seeded), so the window sums are
points of the group and two trees that add in other orders give the same
affine sums from other digits: the line gives a digest of each shape's
affine sums (`utils/interop.affine_from_planes`), equal between trees that
compute the same function.

Two times a launch, each the quartiles of --rounds rounds: `eager_ms`,
--reps launches from Python between two CUDA events (the host's launch
rate included where it is the slower), and `graph_ms`, the same launches
captured once in a CUDA graph and replayed between two events (the device
alone, as in the paths' stage graphs). Then the resident call, which
launches it at the second shape (`gpu_engine._device_msm` at 2^20 on random
residues, w 16 signed, C 2048 x L 512, through the stage graphs, warm): the
quartiles of --rounds walls, each the least of five host-clock walls ended
by a sync.

To compare two trees on one card, run it from the root of each in turns in
one call (parent, change, change, parent): the package is imported from the
working directory. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

SHAPES = {"wire": (20, 129, 5), "resident": (16, 1025, 5), "gs4": (16, 8200, 2)}


def quartiles(xs: list) -> list:
    return statistics.quantiles(xs, n=4, method="inclusive")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label", nargs="?", default=os.path.basename(os.getcwd()))
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    from webgpu_msm_tpu_torch.engines import gpu_engine
    from webgpu_msm_tpu_torch.ops.kernels import build
    from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
    from webgpu_msm_tpu_torch.utils import fixtures
    from webgpu_msm_tpu_torch.utils.interop import affine_from_planes, mont_planes_from_points, planes_from_numpy

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    build.load()
    out = {"label": args.label, "card": smi, "rounds": args.rounds, "reps": args.reps,
           "ptxas": build.ptxas_report()["reduce_finish_kernel"]}
    dev = torch.device("cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def event_ms(fn) -> float:
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    for seed, (shape, (K, G, d)) in enumerate(SHAPES.items(), start=16):
        pts = mont_planes_from_points(fixtures.distinct_points_fast(2 * K * G, seed=seed))
        T, U = (planes_from_numpy(pts[..., i * K * G:(i + 1) * K * G].copy(), dev) for i in (0, 1))
        launch = lambda: pk.reduce_finish(T, U, K, d)
        digest = hashlib.sha256(repr(affine_from_planes(launch()[1].cpu().numpy())).encode()).hexdigest()[:16]

        def launches():
            for _ in range(args.reps):
                launch()

        eager = [event_ms(launches) / args.reps for _ in range(args.rounds)]
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        with torch.cuda.stream(stream):
            launch()  # the library loaded and the allocator warm before the capture
            torch.cuda.synchronize()
            with torch.cuda.graph(graph, stream=stream):
                launches()
        graph.replay()
        replayed = [event_ms(graph.replay) / args.reps for _ in range(args.rounds)]
        out[shape] = {"K": K, "G": G, "doublings": d, "affine_digest": digest,
                      "eager_ms": quartiles(eager), "graph_ms": quartiles(replayed)}
        del T, U, graph
    gen = torch.Generator().manual_seed(16)
    d = torch.randint(0, 1 << 16, (3, 16, 1 << 20), generator=gen, dtype=torch.int32)
    d[:, 15] = torch.randint(0, 0x12AB, (3, 1 << 20), generator=gen, dtype=torch.int32)  # below p
    words = torch.randint(-(1 << 31), 1 << 31, (8, 1 << 20), generator=gen, dtype=torch.int32)
    words[7] &= (1 << 29) - 1  # below 2^253: signed digits apply
    pts, words = d.to(dev), words.to(dev)

    def wall_ms() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu_engine._device_msm(pts, words, window_size=16, n_chunks=2048, chunk_len=512, signed_digits=True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms()  # the first call captures the stage graphs
    out["resident_call_ms"] = quartiles([min(wall_ms() for _ in range(5)) for _ in range(args.rounds)])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
