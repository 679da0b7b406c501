"""A probe at sizes no cell runs: the input maker and the plain reference
at n points, then, once and untimed by the benchmark, the program's
public API on the first set against the reference. Not run by the
benchmark's runs; for the chip, one size a process:

    python3 -m msm_bench.probe --points 67108864 --sets 8 --fixed --port plan
    python3 -m msm_bench.probe --points 2097152 --sets 1 --port compute_msm

Prints one JSON line a stage: the inputs (wall seconds, the device's peak
allocated bytes, the process's peak resident bytes), the reference on
each set (seconds), and the program's call (match or mismatch, or the
error it raised; wall seconds; the device's peak).
"""
from __future__ import annotations

import argparse
import gc
import json
import resource
import sys
import time
import traceback

import torch

from .reference import expected, inputs as reference_inputs


def _peak_rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024  # Linux reports KiB


def _fresh_peak(device: torch.device) -> None:
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)


def _port(kind: str, made, device: torch.device) -> dict:
    import webgpu_msm_tpu_torch as msm

    s = made.sets[0]
    out = {"stage": "port", "entry": kind, "points": len(s.chain_index)}
    _fresh_peak(device)
    t0 = time.perf_counter()
    try:
        if kind == "plan":
            plan = msm.MSMPlan(s.points, device=device)
            torch.cuda.synchronize(device)
            out["plan_build_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = plan.msm(s.scalars)
            del plan
        else:
            r = msm.compute_msm(s.points, s.scalars, device=device)
        torch.cuda.synchronize(device)
        out["call_s"] = time.perf_counter() - t0
        got = (r.x, r.y)
    except Exception as e:  # a probe records what the program did, an out-of-memory included
        traceback.print_exc()
        out["error"] = f"{type(e).__name__}: {e}"[:400]
        got = None
    out["device_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["device_peak_reserved_bytes"] = torch.cuda.max_memory_reserved(device)
    _fresh_peak(device)
    if got is not None:
        out["match"] = got == expected.expected_result(made.k0, s, device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--fixed", action="store_true", help="one point array for every set")
    ap.add_argument("--seed", type=int, default=2**31 + 21)
    ap.add_argument("--port", choices=("none", "compute_msm", "plan"), default="none")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the probe needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.zeros(1, device=device)  # the context, before the clock starts
    _fresh_peak(device)
    t0 = time.perf_counter()
    made = reference_inputs.make_inputs(args.seed, [args.points], args.sets, args.fixed, 253, device)
    torch.cuda.synchronize(device)
    print(json.dumps({"stage": "inputs", "points": args.points, "sets": args.sets, "fixed": args.fixed,
                      "wall_s": time.perf_counter() - t0,
                      "device_peak_bytes": torch.cuda.max_memory_allocated(device),
                      "peak_rss_bytes": _peak_rss_bytes()}), flush=True)
    _fresh_peak(device)
    seconds = []
    for s in made.sets:
        t0 = time.perf_counter()
        expected.expected_result(made.k0, s, device)
        seconds.append(time.perf_counter() - t0)
    print(json.dumps({"stage": "reference", "points": args.points, "seconds_per_set": seconds,
                      "device_peak_bytes": torch.cuda.max_memory_allocated(device),
                      "peak_rss_bytes": _peak_rss_bytes()}), flush=True)
    if args.port != "none":
        print(json.dumps(_port(args.port, made, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
