"""Build the port's native host libraries with g++ at first use and load
them with ctypes.

`csrc/msm_cpu.cpp` (4x64-bit-limb Montgomery Pippenger, OpenMP over
windows) compiles into `build/torch_native/libmsm_cpu-<hash>.so` at the
repository root (git ignores `build/`), where the hash covers the source,
the flags and the host's CPU (`-march=native` builds for it): a changed
source, or a build directory copied to another CPU, builds anew; otherwise
what is there is loaded. `csrc/row_copy.cpp`, the GPU engine's staging
copier (`rows.py`), builds the same way with its own flags, without
OpenMP. The compiler writes a temporary file that is renamed into place, so
two processes building at once each install a whole library. Nothing here
runs at import. Without g++ (or OpenMP, for the MSM library) the build
raises `NativeBuildError`; there is no fallback.
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
ROW_COPY_SOURCE = SOURCE.with_name("row_copy.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
ROW_COPY_FLAGS = ("-O3", "-march=native", "-pthread", "-shared", "-fPIC", "-std=c++17")
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


def library_path(source: Path = SOURCE, flags: tuple | None = None) -> Path:
    """Where `source` built with `flags` (the MSM library's `CXX_FLAGS` by
    default) lies: `lib<stem>-<hash>.so` under `BUILD_DIR`."""
    flags = CXX_FLAGS if flags is None else flags
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(_host_cpu().encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, flags: tuple | None = None) -> Path:
    """Compile `source` with `flags` (`library_path`'s defaults) unless this
    source hash is already built."""
    flags = CXX_FLAGS if flags is None else flags
    so = library_path(source, flags)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run([CXX, *flags, "-o", tmp, str(source)],
                       check=True, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, so)
    except FileNotFoundError as e:
        raise NativeBuildError(f"no C++ compiler ({CXX}): {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(f"native build of {source.name} failed ({CXX}):\n{e.stderr}") from e
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
