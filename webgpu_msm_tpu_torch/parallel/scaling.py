"""Scaling model and the virtual-mesh weak-scaling trend.

The counterpart of the JAX package's `parallel/scaling.py`. No machine
this port is tested on holds more than one card, so, as there, two proxies:

1. **An analytic collective model.** The payload of each collective mode
   a shard (256 B a gathered point), against a single-card compute time
   measured in the same run, under a stated link rate:
   `NVLINK_BYTES_PER_S`, the H100 SXM's NVLink 4 as NVIDIA specifies it
   (900 GB/s in both directions together, 450 GB/s each way). That rate is
   a data-sheet figure, not a measurement: a ring all-gather of payload S a
   card costs about S * (D - 1) / rate, plus the log-depth tree of adds.

2. **The virtual-mesh weak-scaling trend.** The sharded MSM at D = 1, 2,
   4 with a fixed number of points a shard, every shard on one device.
   CAVEAT: the shards time-share that one card (or CPU), so the wall time
   records the dispatch overhead and the collective's correctness, NOT
   NVLink or any scaling across cards; it is labelled as such.

    python -m webgpu_msm_tpu_torch.parallel.scaling [--device cpu]

measures the single-card time (the device-resident 2^20 call on the card;
on the CPU, with `--device cpu`, the plain versions at 2^8 points) and
prints both tables (`benchmark.py --scaling` runs it).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink 4, one direction: a data-sheet rate
POINT_COORD_BYTES = 4 * 16 * 4  # [4, 16] int32 digit planes a point


def payload_bytes(window_size: int, signed_digits: bool, mode: str) -> int:
    """A shard's payload in one sharded MSM's all-gather."""
    from ..ops import pippenger, windows

    K = windows.n_windows(window_size)
    if mode == "window_sums":
        return K * POINT_COORD_BYTES
    return K * pippenger.n_buckets(window_size, signed_digits) * POINT_COORD_BYTES


def modeled_efficiency(
    compute_s: float,
    payload: int,
    n_devices: int,
    tree_add_s_per_level: float = 0.0,
    link_bytes_per_s: float = NVLINK_BYTES_PER_S,
) -> float:
    """Weak-scaling efficiency t_compute / (t_compute + t_collective): a ring
    all-gather brings each card D - 1 payloads, and the combine adds
    (D - 1).bit_length() levels of point adds."""
    if n_devices == 1:
        return 1.0
    t_coll = payload * (n_devices - 1) / link_bytes_per_s
    t_tree = tree_add_s_per_level * max(1, (n_devices - 1).bit_length())
    return compute_s / (compute_s + t_coll + t_tree)


@dataclass
class ScalingRow:
    n_devices: int
    n_points: int
    wall_s: float
    # Efficiency against the smallest D that ran (base_devices).
    efficiency_vs_base: float
    base_devices: int = 1


def _words(n: int, seed: int) -> np.ndarray:
    """[8, n] LE u32 scalar words below 2^253."""
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    words[7] &= 0x1FFFFFFF
    return words.astype(np.uint32)


def _niels(n: int, device: torch.device) -> torch.Tensor:
    """[3, 16, n] Montgomery Niels planes of `_plain_planes` on `device`."""
    from ..ops.kernels import padd_kernels as pk
    from ..utils.interop import planes_from_numpy

    return pk.to_niels(planes_from_numpy(_plain_planes(n), device))


def _plain_planes(n: int) -> np.ndarray:
    """[3, 16, n] plain (x, y, t) digit planes: 256 distinct points, repeated."""
    from ..engines import gpu_engine
    from ..utils import fixtures

    m = min(n, 256)
    base = gpu_engine.marshal_points(fixtures.distinct_points_fast(m, seed=11), m)
    return base[:, :, np.arange(n) % m]


def weak_scaling_trend(
    d_values=(1, 2, 4),
    *,
    window_size: int = 8,
    n_chunks: int = 8,
    chunk_len: int = 8,
    mode: str = "window_sums",
    signed_digits: bool = True,
    iters: int = 3,
    device=None,
) -> list[ScalingRow]:
    """The sharded MSM at n_chunks * chunk_len points a shard for each D,
    every shard on `device` (the card by default): median wall time of
    `iters` calls after one untimed call, each ended by fetching the
    window sums to the host."""
    from ..engines.gpu_engine import resolve_device
    from ..utils.interop import planes_from_numpy
    from .msm_sharded import default_mesh, msm_window_sums_sharded

    dev = resolve_device(device)
    rows: list[ScalingRow] = []
    t_base = base_d = None
    for D in d_values:
        n = D * n_chunks * chunk_len
        niels, words = _niels(n, dev), planes_from_numpy(_words(n, 12), dev)
        mesh = default_mesh(D, dev)

        def run():
            msm_window_sums_sharded(
                niels, words, window_size=window_size, n_chunks=n_chunks, chunk_len=chunk_len,
                mesh=mesh, mode=mode, signed_digits=signed_digits,
            ).cpu()

        run()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        wall = float(np.median(times))
        if t_base is None:
            t_base, base_d = wall, D
        rows.append(ScalingRow(D, n, wall, t_base / wall, base_devices=base_d))
    return rows


def print_report(
    compute_s: float,  # single-card time of the 2^20 call, measured by the caller
    window_size: int = 16,
    signed_digits: bool = True,
    *,
    device=None,
    trend: dict | None = None,  # keywords of weak_scaling_trend
) -> None:
    print("== Analytic collective model (H100 SXM NVLink 4: 450 GB/s each way, "
          "a data-sheet rate, not measured) ==")
    print(f"compute_s={compute_s} (one device's call, measured by the caller)")
    for mode in ("window_sums", "buckets"):
        pl = payload_bytes(window_size, signed_digits, mode)
        effs = ", ".join(
            f"D={d}: {modeled_efficiency(compute_s, pl, d):.4f}" for d in (2, 4, 8, 16, 64)
        )
        print(f"mode={mode:12s} payload/device={pl / 1e6:9.3f} MB  -> {effs}")

    rows = weak_scaling_trend(device=device, **(trend or {}))
    print(f"\n== Virtual-mesh weak-scaling trend on {_device_name(device)} (the shards")
    print("   time-share one device: NOT an NVLink or multi-card measurement; it records")
    print("   dispatch overhead and the collective's correctness only) ==")
    for r in rows:
        print(f"D={r.n_devices}  n={r.n_points:8d}  wall={r.wall_s * 1e3:9.2f} ms"
              f"  eff(vs D={r.base_devices})={r.efficiency_vs_base:.3f}")


def _device_name(device) -> str:
    from ..engines.gpu_engine import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return "the CPU (plain versions)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index or 0]
    return f"{torch.cuda.get_device_name(dev)} [{smi}]"


def single_card_s(device=None, n_pow: int = 20, iters: int = 5) -> float:
    """Median wall seconds of the device-resident call (`_device_msm` on
    plain planes and words already on `device`, the resident rules: w 16
    signed in one batch of C 2048 x L 512 at 2^20), after one untimed call,
    each ended by fetching the window sums."""
    from ..config import MSMConfig
    from ..engines import gpu_engine
    from ..utils.interop import planes_from_numpy

    dev = gpu_engine.resolve_device(device)
    n, cfg = 1 << n_pow, MSMConfig()
    pts = planes_from_numpy(_plain_planes(n), dev)
    sc = planes_from_numpy(_words(n, 12), dev)
    (C, L), w = cfg.resolved_chunking(n), cfg.resolved_window_size(n)
    call = lambda: gpu_engine._device_msm(pts, sc, window_size=w, n_chunks=C, chunk_len=L,
                                          signed_digits=True).cpu()
    call()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device; default: the GPU")
    args = ap.parse_args(argv)
    on_card = args.device is None or torch.device(args.device).type == "cuda"
    # On the card: the 2^20 call, and 2^18 points a shard at w 16 signed (the
    # resident rule's window); on the CPU, the plain versions at 2^8 points,
    # and 64 points a shard at w 8.
    n_pow = 20 if on_card else 8
    compute_s = single_card_s(args.device, n_pow, iters=5 if on_card else 1)
    print(f"device-resident call at 2^{n_pow} on {_device_name(args.device)}: {compute_s * 1e3:.3f} ms")
    trend = (dict(window_size=16, n_chunks=2048, chunk_len=128) if on_card
             else dict(window_size=8, n_chunks=8, chunk_len=8, iters=1))
    print_report(compute_s, device=args.device, trend=trend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
