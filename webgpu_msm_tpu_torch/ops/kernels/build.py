"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

`csrc/*.cu` compile, one nvcc process per source and all at once, into
objects that link into one shared library with a plain C interface,
`build/torch_kernels/libmsm_kernels-<hash>.so` at the repository root (git
ignores `build/`), where the hash covers the sources and the flags: a
changed source builds anew, an unchanged one loads what is there. Nothing
here runs at import; a machine without nvcc fails at the first kernel
launch, never on the CPU path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")  # when nvcc is not on PATH
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types, the last two the device index of the
# tensors and the stream; each returns cudaGetLastError() as int.
SIGNATURES = {
    "launch_to_niels_xy": (_P, _P, _I, _I, _P),
    "launch_to_niels": (_P, _P, _I, _I, _P),
    "launch_padd": (_P, _P, _P, _I, _I, _P),
    "launch_padd_masked": (_P, _P, _P, _P, _I, _I, _P),
    "launch_accumulate_scan": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "launch_accumulate_scan_mma": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "launch_accumulate_scan_gather": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "launch_accumulate_scan_gather_mma": (_P,) * 8 + (_I, _I, _I, _I, _I, _P),
    "launch_grouped_running_sum": (_P, _P, _P, _I, _I, _I, _I, _P),
    "launch_reduce_finish": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "launch_lane_scan": (_P, _P, _P, _P, _I, _I, _I, _P),
    "launch_assemble_buckets": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "launch_to_niels_xy_rows": (_P, _P, _I, _I, _P),
    "launch_finish_affine_divsteps": (_P, _P, _I, _I, _P),
}

# Kernels whose occupancy the library reports: C entry point
# `occupancy_<name>(int* warps)`, the warps of `<name>_kernel` that one SM
# holds at the block size its launch uses.
OCCUPANCY = ("accumulate_scan_gather", "accumulate_scan_gather_mma")

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libmsm_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _output(what: str, returncode: int, output: str) -> str:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({returncode}):\n{output}")
    return output


def build() -> Path:
    """Compile the kernels unless this source hash is already built; the
    compiler's -Xptxas -v report is kept beside the library (.log)."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        objs = {cu: Path(tmp) / (cu.stem + ".o") for cu in sorted(CSRC.glob("*.cu"))}
        procs = {
            cu: subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for cu, obj in objs.items()
        }
        # Wait for every compiler before raising for one.
        outputs = {cu: proc.communicate()[0] for cu, proc in procs.items()}
        log = "".join(_output(cu.name, procs[cu].returncode, out) for cu, out in outputs.items())
        lib = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *map(str, objs.values())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log += _output("the link", link.returncode, link.stdout)
        so.with_suffix(".log").write_text(log)
        os.replace(lib, so)  # atomic: a concurrent build installs a whole file too
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built if needed; argument types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        for name in OCCUPANCY:
            fn = getattr(lib, "occupancy_" + name)
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
        lib.msm_error_string.argtypes = [ctypes.c_int]
        lib.msm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ptxas_report() -> dict[str, str]:
    """Kernel name -> its ptxas lines (registers, spills, shared memory),
    read from the log of the current build."""
    log = library_path().with_suffix(".log")
    report: dict[str, list[str]] = {}
    current = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            report[current] = []
        elif current and re.search(r"registers|spill|smem", line):
            report[current].append(line.replace("ptxas info    :", "").strip())
    return {k: "; ".join(v) for k, v in report.items()}


def occupancy() -> dict[str, int]:
    """Kernel name (`<name>_kernel`) -> warps an SM at its launch's block
    size, from the CUDA runtime's occupancy calculator (OCCUPANCY)."""
    lib, out = load(), {}
    for name in OCCUPANCY:
        warps = ctypes.c_int(0)
        rc = getattr(lib, "occupancy_" + name)(ctypes.byref(warps))
        if rc != 0:
            raise RuntimeError(f"occupancy of {name}: {lib.msm_error_string(rc).decode()}")
        out[name + "_kernel"] = warps.value
    return out
