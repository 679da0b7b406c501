"""Build the native CPU MSM library with g++ at first use and load it with
ctypes.

`csrc/msm_cpu.cpp` (4x64-bit-limb Montgomery Pippenger, OpenMP over
windows) compiles into `build/torch_native/libmsm_cpu-<hash>.so` at the
repository root (git ignores `build/`), where the hash covers the source,
the flags and the host's CPU (`-march=native` builds for it): a changed
source, or a build directory copied to another CPU, builds anew; otherwise
what is there is loaded. The compiler writes a temporary file that is renamed into place, so
two processes building at once each install a whole library. Nothing here
runs at import. Without g++ or OpenMP the build raises `NativeBuildError`;
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "msm_cpu.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 300  # the build takes seconds; a compiler that hangs fails the call

_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    pass


def _host_cpu() -> str:
    """The CPU's model and instruction-set flags, as `-march=native` sees
    them."""
    try:
        info = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.processor() or platform.machine()
    return "\n".join(sorted({line for line in info.splitlines()
                              if line.startswith(("model name", "flags"))}))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmsm_cpu-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source hash is already built."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, so)
    except FileNotFoundError as e:
        raise NativeBuildError(f"no C++ compiler ({CXX}): {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(f"native build failed ({CXX}, OpenMP):\n{e.stderr}") from e
    except subprocess.TimeoutExpired as e:
        raise NativeBuildError(f"native build ({CXX}) still running after {e.timeout} s") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load() -> ctypes.CDLL:
    """The native library, built if needed; argument types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.msm_run.restype = ctypes.c_int
        lib.msm_run.argtypes = [
            u64p,  # points [n][3][4], plain affine x, y, t
            u64p,  # scalars [n][4]
            ctypes.c_size_t,  # n
            ctypes.c_int,  # window bits
            ctypes.c_int,  # threads (0: OpenMP's default)
            u64p,  # out [2][4], plain affine x, y
        ]
        lib.point_add_affine.restype = ctypes.c_int
        lib.point_add_affine.argtypes = [u64p] * 3
        _lib = lib
    return _lib
