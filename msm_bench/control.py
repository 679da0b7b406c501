"""The readings that the comparison's limits are set from, on the chip at
a cell's own size: the program and the control (the plain reference at
a lower precision in the program's place), over many seeds in one
process, each a short window. Not run by the benchmark's runs.

    python3 -m msm_bench.control --workload <cell> --seeds 11,12,13 --seconds 2 --entry control
    python3 -m msm_bench.control --workload <cell> --seeds 21,...,32 --seconds 2 --entry program

Prints one JSON line a seed: the seed, `correct`, the MSMs compared and
each check's number beside its limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import harness
from .reference import control_entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--entry", choices=("program", "control"), required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell, _ = harness.load_cell(args.workload)
    if args.entry == "control":
        cell.entry = control_entry
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(cell, seed, args.seconds, False, args.device, time.perf_counter(),
                                  stderr=sys.stdout)
        print(json.dumps({"workload": args.workload, "entry": args.entry, "seed": seed,
                          "correct": result["correct"], "compared": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
