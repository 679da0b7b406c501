#!/usr/bin/env python3
"""The gathering scan of the port in whatever tree it is run from, on CIOS
products and on the tensor cores (`accumulate_scan_gather(use_mma=)`):
CUDA-event time a launch at the wire call's shape (w 13 signed, a batch of
C 2048 x L 128: K 20 windows, B 4 128 buckets) and at the resident call's
(w 16 signed, C 2048 x L 512: K 16, B 32 800), both kernels required equal
on every output digit, with the ptxas line and occupancy of each kernel.

    python3 scripts/torch_scan_timing.py [label] [--reps N]   (one NVIDIA GPU, nvcc)

To compare two trees on one card, run it from the root of each in turns in
one call (parent, change, change, parent). The package is imported from the
working directory, so this file may time another tree than its own. Inputs
are seeded (torch.Generator, seed 12). Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())


def scan_inputs(gen: torch.Generator, K: int, C: int, L: int, B: int, dev) -> tuple:
    """rows [C * L, 24] of packed Niels limbs below p, and perm and ids
    [L, K * C] as a batch stage makes them: each window's signed bucket ids
    sorted (stable), with the sort's permutation."""
    M, W = C * L, K * C
    as_i32 = lambda t: torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)
    lanes = lambda t: as_i32(t).reshape(K, C, L).permute(2, 0, 1).reshape(L, W).contiguous().to(dev)
    digits = torch.randint(0, B, (K, M), generator=gen)
    order = torch.sort(digits, dim=1, stable=True).indices
    signs = torch.randint(0, 2, (K, M), generator=gen) << 31
    sorted_ids = torch.gather(digits | signs, 1, order)
    d = torch.randint(0, 1 << 16, (3, 16, M), generator=gen, dtype=torch.int64)
    d[:, 15] = torch.randint(0, 0x12AB, (3, M), generator=gen)  # below p
    rows = as_i32(d[:, 0::2] | (d[:, 1::2] << 16)).reshape(24, M).t().contiguous().to(dev)
    return rows, lanes(order), lanes(sorted_ids), K, B


def event_ms(fn, reps: int) -> float:
    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label", nargs="?", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    from webgpu_msm_tpu_torch.ops.kernels import build
    from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    build.load()
    ptxas, occupancy = build.ptxas_report(), build.occupancy()
    kernels = ("accumulate_scan_gather_kernel", "accumulate_scan_gather_mma_kernel")
    out = {"label": args.label, "card": smi, "reps": args.reps,
           "ptxas": {k: ptxas[k] for k in kernels}, "warps_per_sm": {k: occupancy[k] for k in kernels}}
    gen, dev = torch.Generator().manual_seed(12), torch.device("cuda")
    for shape, dims in (("wire", (20, 2048, 128, 4128)), ("resident", (16, 2048, 512, 32800))):
        scan = scan_inputs(gen, *dims, dev)
        outs = {m: pk.accumulate_scan_gather(*scan, use_mma=m) for m in (False, True)}
        if not all(torch.equal(a, b) for a, b in zip(outs[False], outs[True])):
            raise RuntimeError(f"{shape}: the tensor-core gathering scan differs from the CIOS one")
        for m, name in ((False, "cios_ms"), (True, "mma_ms")):
            out.setdefault(shape, {})[name] = event_ms(
                lambda: pk.accumulate_scan_gather(*scan, use_mma=m), args.reps)
        del scan, outs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
