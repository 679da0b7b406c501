"""The GPU engine's staging copier (`csrc/row_copy.cpp`), built with g++
at first use (`build.py`) and loaded with ctypes, which releases the GIL
for each copy.

`copy_rows(dst, src)` writes the first `dst.shape[1]` u32 words of each
row of `src` into the contiguous rows of `dst`: byte for byte what
`np.copyto(dst, src[:, :dst.shape[1]])` writes, for the wire path's x||y
words (16 of each 32-word point row) and its scalar rows (8 of 8). numpy's
copy of such rows runs a loop a row on one core, and for x||y it is slower
than a contiguous copy of twice the bytes; this one copies 32-byte lanes
with streaming stores and, from `PARALLEL_ROWS` rows on, shares the rows
with a pool of sleeping workers, one fewer than the host's CPUs.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import build

# From this many rows on, a copy is shared with the pool; below it the
# caller copies alone. A shared copy waits for its slowest thread, and on a
# shared host a worker that loses its core for a time slice costs ms. On an
# H100's 8-CPU host (`scripts/torch_staging_probe.py`, pinned rows, 41
# writes a size) x||y at 2^16 rows took 0.27 ms with the pool against 0.89
# alone, but its slowest write 6.0 ms; at 2^17 rows 0.42-0.44 ms against
# 1.84-1.92 alone, the slowest 0.52; at 2^18 0.84 against 3.74.
PARALLEL_ROWS = 1 << 17

_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build(build.ROW_COPY_SOURCE, build.ROW_COPY_FLAGS)))
        lib.row_copy.restype = ctypes.c_int
        lib.row_copy.argtypes = [
            ctypes.c_void_p,  # dst, rows x row_bytes
            ctypes.c_void_p,  # src, rows x src_stride
            ctypes.c_size_t,  # rows
            ctypes.c_size_t,  # row_bytes
            ctypes.c_size_t,  # src_stride, bytes
            ctypes.c_int,  # parallel
        ]
        lib.row_copy_workers.restype = ctypes.c_int
        lib.row_copy_workers.argtypes = []
        _lib = lib
    return _lib


def copy_rows(dst: np.ndarray, src: np.ndarray, *, _parallel: bool | None = None) -> bool:
    """Write `src[:, :w]` into `dst`, [rows, w] contiguous u32; `src` is
    [rows, >= w] u32 with contiguous rows. Returns whether the pool took
    part. `_parallel` (tests, probes) forces the pool on or off."""
    rows, width = dst.shape
    if (dst.dtype != np.uint32 or src.dtype != np.uint32 or src.ndim != 2
            or src.shape[0] != rows or src.shape[1] < width or not dst.flags.writeable):
        raise ValueError(f"copy_rows: cannot copy {src.dtype} {src.shape} into {dst.dtype} {dst.shape}")
    if rows == 0:
        return False
    if not dst.flags.c_contiguous or src.strides[1] != 4 or src.strides[0] < width * 4:
        raise ValueError(f"copy_rows: needs contiguous destination rows and source words, "
                         f"not strides {dst.strides} and {src.strides}")
    parallel = rows >= PARALLEL_ROWS if _parallel is None else _parallel
    return bool(_load().row_copy(dst.ctypes.data, src.ctypes.data, rows, width * 4,
                                 src.strides[0], int(parallel)))


def workers() -> int:
    """The pool's workers besides the caller (0 on a one-CPU host)."""
    return _load().row_copy_workers()
