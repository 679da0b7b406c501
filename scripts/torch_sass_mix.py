#!/usr/bin/env python3
"""Static instruction mix of the port's CUDA kernels: builds the kernel
library of the tree it is run from, disassembles it with cuobjdump and
prints, for each kernel whose name contains one of the given words, its
SASS instruction count by opcode (the opcode's first dotted part), most
frequent first. The scan kernels unroll their step body, so a count here is
close to the count a step.

    python3 scripts/torch_sass_mix.py [word ...] [--top N]   (nvcc and cuobjdump)

Default words: accumulate_scan_gather. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("words", nargs="*", default=["accumulate_scan_gather"])
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    from webgpu_msm_tpu_torch.ops.kernels import build

    so = build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, check=True,
                          timeout=600).stdout
    mix: dict[str, collections.Counter] = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            current = m.group(1) if any(w in m.group(1) for w in args.words) else None
            if current:
                mix[current] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if current and m:
            mix[current][m.group(1)] += 1
    print(json.dumps({k: {"total": sum(c.values()), "top": dict(c.most_common(args.top))}
                      for k, c in mix.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
