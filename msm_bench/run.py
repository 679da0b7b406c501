"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m msm_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result (JSON); the numbers
compared with the plain reference, each beside its limit, are the last
lines of standard error and the result's last key. Exits non-zero, with
no result, without a CUDA device, when the program cannot be imported,
or when jax, jaxlib, flax or the JAX package is loaded once the window
has closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here: imports, inputs, warm-up

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None, device: str = "cuda") -> int:
    """`device` "cpu" runs the rest of a run on the program's plain
    versions without looking for a card: for the benchmark's own tests."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import harness

    cell, chips = harness.load_cell(args.workload)
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_PROCESS)
    except harness.ForbiddenImport as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
