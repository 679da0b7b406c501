"""Benchmark harness: the counterpart of the JAX package's `benchmark.py`.

Runs each engine over a set of input sizes, checks each result against the
exact expected value (repeated-base cases have an O(1) expected result,
sum(s_i) * B, the distribution of the reference's random-input mode), and
collects `[inputSize, msmFunc, timeMS, correct]` rows with a CSV export.

    python -m webgpu_msm_tpu_torch.benchmark --sizes 16,18,20 --engines gpu,cpu \
        --csv results.csv [--window-sweep [--signed] [--unsigned]] [--device cpu]
    python -m webgpu_msm_tpu_torch.benchmark --scaling [--device cpu]

Engines are the port's (`gpu` is the JAX package's `tpu`). Without
`--device` the GPU engines run on the card (and fail without one);
`--device cpu` runs every kernel's plain PyTorch version. On the card the
first call at a new shape captures each stage as a CUDA graph
(`utils/cache.py`) and a warm call replays them: with `--iters 1` a row's
time is that first call's, so time warm calls with `--iters` > 1 (the
median). The window sweep
covers the signed digits of the default configuration, or the digit forms
named with `--signed` and `--unsigned`. `--scaling` prints the multi-GPU
layer's collective model and its virtual-mesh trend
(`python -m webgpu_msm_tpu_torch.parallel.scaling`, run as a subprocess).
"""
from __future__ import annotations

import argparse
import csv
import sys
import time

import numpy as np

from . import compute_msm
from .config import SUPPORTED_WINDOW_SIZES, MSMConfig
from .oracle import curve, field
from .oracle.testdata import base_point
from .utils import convert

FIELDS = ["inputSize", "msmFunc", "timeMS", "correct"]


def _case(n: int, seed: int = 99):
    """n copies of the base point, n random scalars below 2^253, and the
    expected affine result (sum of the scalars) * B."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    raw[:, 0] &= 0x1FFFFFFF  # < 2^253 (BE rows: word 0 is the top word)
    scalars = convert.u32_be_to_bigints(raw.astype(np.uint32))
    b = base_point()
    expected = curve.to_affine(curve.scalar_mul(b, sum(scalars)))
    return [b] * n, scalars, expected


def _wire_case(n: int, seed: int = 99):
    """`_case` as wire-format inputs ([n, 32] and [n, 8] BE u32 rows) and
    its expected result."""
    points, scalars, expected = _case(n, seed)
    b = points[0]
    row = convert.bigints_to_u32_be([b.x % field.P, b.y % field.P, b.t % field.P, 1]).reshape(32)
    return np.broadcast_to(row, (n, 32)).copy(), convert.bigints_to_u32_be(scalars), expected


def _row(n_pow: int, label: str, ms: float, ok: bool) -> dict:
    print(f"2^{n_pow:<3d} {label:28s} {ms:10.1f} ms  {'ok' if ok else 'WRONG'}")
    return {"inputSize": n_pow, "msmFunc": label, "timeMS": round(ms, 2), "correct": ok}


def _timed(call, expected, iters: int) -> tuple[float, bool]:
    """Median wall ms of `iters` calls and whether every result was
    `expected`; an error is reported and counts as wrong."""
    try:
        times, ok = [], True
        for _ in range(iters):
            t0 = time.perf_counter()
            res = call()
            times.append((time.perf_counter() - t0) * 1000)
            ok = ok and (res.x, res.y) == expected
        return float(np.median(times)), ok
    except Exception as e:  # report, keep sweeping
        print(f"  ERROR: {type(e).__name__}: {e}", file=sys.stderr)
        return float("nan"), False


def run(sizes: list[int], engines: list[str], windows: list[int] | None = None, iters: int = 1,
        device=None, digit_forms: tuple[bool, ...] = (True,)) -> list[dict]:
    """One row per size, engine, window and digit form (`digit_forms`:
    True for signed digits, False for unsigned), over `_case`'s lists."""
    rows = []
    for n_pow in sizes:
        points, scalars, expected = _case(1 << n_pow)
        for engine in engines:
            for w in windows or [None]:
                for signed in digit_forms:
                    cfg = MSMConfig(window_size=w, signed_digits=signed)
                    ms, ok = _timed(lambda: compute_msm(points, scalars, config=cfg, engine=engine,
                                                        device=device), expected, iters)
                    label = (engine if w is None else f"{engine}(w={w})") + ("" if signed else " unsigned")
                    rows.append(_row(n_pow, label, ms, ok))
    return rows


def run_ratio_sweep(n_pow: int, ratios: list[float], iters: int = 3, device=None) -> list[dict]:
    """cpu_work_ratio sweep on wire inputs: whether any split of the native
    CPU engine and the GPU engine beats the GPU engine alone on this host."""
    pw, sw, expected = _wire_case(1 << n_pow)
    rows = []
    for ratio in ratios:
        cfg = MSMConfig(cpu_work_ratio=ratio)
        engine = "hybrid" if ratio > 0 else "gpu"
        label = f"hybrid(ratio={ratio})" if ratio > 0 else "gpu"
        call = lambda: compute_msm(pw, sw, config=cfg, engine=engine, device=device)
        _timed(call, expected, 1)  # warm-up
        rows.append(_row(n_pow, label, *_timed(call, expected, iters)))
    best = min((r for r in rows if r["correct"]), key=lambda r: r["timeMS"], default=None)
    if best is not None:
        print(f"best split: {best['msmFunc']} at {best['timeMS']} ms")
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="16", help="comma-separated log2 sizes")
    ap.add_argument("--engines", default="gpu",
                    help="gpu,cpu,hybrid,oracle,naive,baseline (baseline = the Demox "
                    "webgpu_pippenger_msm analog)")
    ap.add_argument("--device", default=None, help="torch device; default: the GPU")
    ap.add_argument("--iters", type=int, default=1, help="timed calls a row (median)")
    ap.add_argument("--csv", default=None, help="write rows to CSV file")
    ap.add_argument("--window-sweep", action="store_true",
                    help="sweep all supported window sizes")
    ap.add_argument("--signed", action="store_true", help="sweep signed digits")
    ap.add_argument("--unsigned", action="store_true", help="sweep unsigned digits")
    ap.add_argument("--ratio-sweep", action="store_true",
                    help="sweep cpu_work_ratio splits on wire inputs")
    ap.add_argument("--scaling", action="store_true",
                    help="multi-GPU scaling report: the NVLink payload model and the "
                    "virtual-mesh weak-scaling trend (parallel/scaling.py)")
    args = ap.parse_args(argv)

    if args.scaling:
        import subprocess

        device = [] if args.device is None else ["--device", args.device]
        return subprocess.call([sys.executable, "-m", "webgpu_msm_tpu_torch.parallel.scaling", *device])

    sizes = [int(s) for s in args.sizes.split(",")]
    windows = list(SUPPORTED_WINDOW_SIZES) if args.window_sweep else None
    forms = tuple(f for f, on in ((True, args.signed), (False, args.unsigned)) if on) or (True,)
    if args.ratio_sweep:
        rows = []
        for n_pow in sizes:
            rows += run_ratio_sweep(n_pow, [0.0, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0], device=args.device)
    else:
        rows = run(sizes, args.engines.split(","), windows, args.iters, args.device, forms)
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=FIELDS)
            writer.writeheader()
            writer.writerows(rows)
        print(f"wrote {len(rows)} rows to {args.csv}")
    return 0 if all(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
