#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the device: name, count, and nvidia-smi's name and power limit.
2. Builds the CUDA kernels from `webgpu_msm_tpu_torch/ops/kernels/csrc`
   with nvcc and prints each kernel's ptxas registers, spills and shared
   memory.
3. Runs each of the five kernels and its plain PyTorch version on the card
   on seeded inputs at the shapes of the 2^20-point main path, requires
   every output digit to be equal, and times both with CUDA events.
4. Drives `compute_msm` on the pinned 2^16 and 2^20 wire inputs
   (regenerated from their seeds), requires the pinned results, and
   requires every kernel's launch count to have moved. Prints the 2^20
   call's wall time, cold and warm.
5. Prints the kernel table as one JSON line, then the result line.

Any failure raises, and the script exits non-zero. It imports nothing of
JAX; it needs the repository's `webgpu_msm_tpu_torch` package beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# The card has no listed integer-ALU peak; the non-tensor float32 rate
# (67 TFLOP/s) is the nearest published peak and bounds 32-bit integer
# multiplies from above, so the bound below is a lower bound on time.
OPS_PER_S = 67e12
# 32-bit multiplies in one 8-limb CIOS Montgomery product (a*b: 64,
# m*p: 64, m: 8), two operations (low and high word) each.
OPS_PER_MONT_MUL = 2 * (64 + 64 + 8)
REPLACES = "webgpu_msm_tpu/ops/pallas/padd_kernels.py:{}"
SOURCE = "webgpu_msm_tpu_torch/ops/kernels/csrc/padd_kernels.cu"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def field_planes(gen: torch.Generator, lead: tuple, width: int) -> torch.Tensor:
    """Random canonical field elements as [*lead, 16, width] int32 digits
    (top digit below p's, so every value is below p)."""
    d = torch.randint(0, 1 << 16, lead + (16, width), generator=gen, dtype=torch.int32)
    d[..., 15, :] = torch.randint(0, 0x12AB, lead + (width,), generator=gen, dtype=torch.int32)
    return d


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """One call, synchronized: (result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    check(a.shape == b.shape and a.dtype == b.dtype, f"shape/dtype {a.shape} {b.shape}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def kernel_inputs(gen: torch.Generator, dev, M=1 << 18, K=20, C=2048, L=128, B=4128,
                  Gs=32) -> dict:
    """Seeded inputs at the main path's shapes (by default those of 2^20
    points: w = 13 signed, batches of M = 2^18, C = 2048, L = 128, so
    K = 20 windows, B = 4128 buckets and Gs = 32)."""
    W, G = K * C, B // Gs
    # Sorted bucket ids per lane with random signs: runs of varying length.
    ids = torch.sort(torch.randint(0, B, (W, L), generator=gen), dim=1).values.t()
    signs = torch.randint(0, 2, (L, W), generator=gen) << 31
    ids = (ids | signs).contiguous()
    niels = field_planes(gen, (3,), L * W).to(torch.int64).reshape(3, 16, L, W)
    packed = niels[:, 0::2] | (niels[:, 1::2] << 16)
    as_i32 = lambda t: torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)
    pts = lambda lead, width: field_planes(gen, lead, width).to(dev)
    return {
        "to_niels_xy": (pts((2,), M),),
        "accumulate_scan": (as_i32(packed).contiguous().to(dev), as_i32(ids).to(dev)),
        "padd_masked": (
            pts((4,), W), pts((4,), W),
            torch.randint(0, 2, (W,), generator=gen, dtype=torch.int32).to(dev),
        ),
        "padd": (pts((4,), K * B), pts((4,), K * B)),
        "grouped_running_sum": (pts((Gs, 4), K * G),),
        "grouped_running_sum pass 2": (pts((G, 4), 2 * K),),
    }


def bound(name: str, args) -> tuple[float, str]:
    """Least time for the work these inputs need: (ms, "bytes"|"operations")."""
    nbytes = sum(a.numel() * 4 for a in args)
    if name == "to_niels_xy":
        M = args[0].shape[-1]
        nbytes += 3 * 16 * M * 4
        muls = 4 * M
    elif name == "accumulate_scan":
        _, _, L, W = args[0].shape
        nbytes += (64 * L * W + 64 * W + W) * 4
        muls = 7 * L * W
    elif name == "padd_masked":
        nbytes += args[0].numel() * 4
        muls = 9 * int((args[2] != 0).sum())
    elif name == "padd":
        nbytes += args[0].numel() * 4
        muls = 9 * args[0].shape[-1]
    else:  # grouped_running_sum
        Gs, _, _, W = args[0].shape
        nbytes += 2 * 64 * W * 4
        muls = 9 * (2 * Gs - 1) * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = muls * OPS_PER_MONT_MUL / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_call(fn, warm_ms: float, top: int = 12) -> None:
    """Where one warm 2^20 call's device time goes: the busiest device ops,
    and the device's busy share of the unprofiled warm wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda e: e.self_device_time_total
    # Kernels only: an aten op's row repeats the device time of its kernels.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        print("profile 2^20: the profiler recorded no device kernels")
        return
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"profile 2^20: device busy {busy_ms:.1f} ms of a {warm_ms:.1f} ms warm call "
          f"(idle share {1 - busy_ms / warm_ms:.3f})")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"profile 2^20:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from webgpu_msm_tpu_torch import MSMConfig, compute_msm
    from webgpu_msm_tpu_torch.ops.kernels import build
    from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
    from webgpu_msm_tpu_torch.oracle.pinned_vectors import PINNED
    from webgpu_msm_tpu_torch.utils import convert, fixtures

    dev = torch.device("cuda")
    # 1. device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    build.load()
    print(f"build: {build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    for kname, line in sorted(build.ptxas_report().items()):
        print(f"ptxas {kname}: {line}")

    # 3. each kernel against its plain version at the main path's shapes
    gen = torch.Generator().manual_seed(20)
    inputs = kernel_inputs(gen, dev)
    kernels = {
        "to_niels_xy": (pk.to_niels_xy, pk.to_niels_xy_plain, 498, 20),
        "accumulate_scan": (pk.accumulate_scan, pk.accumulate_scan_plain, 258, 3),
        "padd_masked": (pk.padd_masked, pk.padd_masked_plain, 158, 20),
        "padd": (pk.padd, pk.padd_plain, 141, 20),
        "grouped_running_sum": (pk.grouped_running_sum, pk.grouped_running_sum_plain, 391, 10),
    }
    # Load each plain version's torch kernels once at a small shape, so its
    # timed call below does not pay for that.
    for kname, small in kernel_inputs(torch.Generator().manual_seed(0), dev, M=64, K=2, C=4,
                                      L=4, B=64, Gs=32).items():
        kernels[kname.split(" ")[0]][1](*small)
    rows = {}
    for kname, (kern, plain, line, reps) in kernels.items():
        args = inputs[kname]
        got, _ = once_ms(lambda: kern(*args))
        want, plain_ms = once_ms(lambda: plain(*args))
        err = max_abs_err(got, want)
        check(err == 0, f"{kname}: kernel differs from its plain version (max abs err {err})")
        del got, want
        if kname == "grouped_running_sum":  # the second pass's shape too
            a2 = inputs["grouped_running_sum pass 2"]
            check(max_abs_err(kern(*a2), plain(*a2)) == 0, f"{kname} pass 2 differs")
        ms = cuda_ms(lambda: kern(*args), reps)
        bound_ms, bound_by = bound(kname, args)
        rows[kname] = {
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES.format(line), "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        }
        print(f"kernel {kname}: equal to plain on {tuple(args[0].shape)}; "
              f"{ms:.4f} ms (plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms by {bound_by}) "
              f"[{smi}]")
        torch.cuda.empty_cache()
    del inputs

    # 4. the main path: compute_msm on the pinned inputs
    cfg = MSMConfig()
    for power in (16, 20):
        t0 = time.perf_counter()
        n = 1 << power
        pts = fixtures.wire_points(fixtures.distinct_points_fast(n, seed=power))
        sc = convert.bigints_to_u32_be(fixtures.random_scalars(n, seed=1000 + power))
        print(f"inputs 2^{power}: regenerated in {time.perf_counter() - t0:.1f} s (host)")
        pk.reset_launch_counts()
        res, cold_ms = once_ms(lambda: compute_msm(pts, sc, config=cfg, device=dev))
        counts = dict(pk.launches)
        check((res.x, res.y) == PINNED[power], f"2^{power}: result differs from PINNED")
        for kname in pk.KERNELS:
            check(counts[kname] > 0, f"2^{power}: kernel {kname} was not launched")
        print(f"compute_msm 2^{power}: equals PINNED[{power}]; launches {counts}")
        if power == 20:
            for kname in pk.KERNELS:
                rows[kname]["launches"] = counts[kname]
            res, warm_ms = once_ms(lambda: compute_msm(pts, sc, config=cfg, device=dev))
            check((res.x, res.y) == PINNED[power], "2^20 warm call differs from PINNED")
            print(f"compute_msm 2^20 wall: cold {cold_ms / 1e3:.3f} s "
                  f"({n / cold_ms * 1e3:.0f} points/s), warm {warm_ms / 1e3:.3f} s "
                  f"({n / warm_ms * 1e3:.0f} points/s) [{smi}]")
            profile_call(lambda: compute_msm(pts, sc, config=cfg, device=dev), warm_ms)

    # 5. summary lines
    print("kernels: " + ", ".join(pk.KERNELS))
    print(json.dumps({"kernels": [rows[k] for k in pk.KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
