"""Native C++ CPU MSM engine: the counterpart of the JAX package's
`engines/cpu_engine.py`.

Wraps the port's own copy of `runtime/csrc/msm_cpu.cpp` through ctypes: a
4x64-bit-limb Montgomery Pippenger, parallel over windows with OpenMP. It
runs alone (`engine="cpu"`, the reference's cpuWorkRatio = 1) and as the
CPU share of the hybrid split. It computes on the host and touches no
device; ctypes releases the interpreter lock for the length of `msm_run`,
so a thread that queues GPU work meanwhile keeps running.
"""
from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np
import torch

from ..config import MSMConfig
from ..oracle import field as ofield
from ..oracle.curve import ExtPoint
from ..runtime import load

_U64P = ctypes.POINTER(ctypes.c_uint64)


def _limbs4(v: int) -> list[int]:
    return [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]


def _xy(out: np.ndarray) -> tuple[int, int]:
    """[8] u64 LE limbs (x then y) -> (x, y)."""
    x = sum(int(out[i]) << (64 * i) for i in range(4))
    y = sum(int(out[4 + i]) << (64 * i) for i in range(4))
    return x, y


def _run(pts: np.ndarray, sc: np.ndarray, window_size: int, n_threads: int) -> tuple[int, int]:
    """`msm_run` over [n, 3, 4] plain affine limbs and [n, 4] scalar limbs."""
    pts = np.ascontiguousarray(pts, dtype=np.uint64)
    sc = np.ascontiguousarray(sc, dtype=np.uint64)
    out = np.zeros(8, dtype=np.uint64)
    # msm_run sets the calling thread's OpenMP thread count, and PyTorch's
    # CPU ops share that runtime (one libgomp.so.1 in the process): put
    # PyTorch's count back, or every later CPU op would fork n_threads.
    torch_threads = torch.get_num_threads()
    try:
        rc = load().msm_run(pts.ctypes.data_as(_U64P), sc.ctypes.data_as(_U64P), pts.shape[0],
                            window_size, n_threads, out.ctypes.data_as(_U64P))
    finally:
        torch.set_num_threads(torch_threads)
    if rc != 0:
        raise RuntimeError(f"msm_run failed with code {rc}")
    return _xy(out)


def msm_window_partial(
    points: Sequence[ExtPoint],
    scalars: Sequence[int],
    window_size: int,
    n_threads: int = 0,
) -> tuple[int, int]:
    """Native MSM over the given points (marshalled point by point in
    Python) -> plain affine (x, y)."""
    n = len(points)
    pts = np.empty((n, 3, 4), dtype=np.uint64)
    for i, p in enumerate(points):
        if p.z != 1:
            zi = ofield.finv(p.z)
            x, y = p.x * zi % ofield.P, p.y * zi % ofield.P
            t = x * y % ofield.P
        else:
            x, y, t = p.x % ofield.P, p.y % ofield.P, p.t % ofield.P
        pts[i, 0] = _limbs4(x)
        pts[i, 1] = _limbs4(y)
        pts[i, 2] = _limbs4(t)
    sc = np.empty((n, 4), dtype=np.uint64)
    for i, s in enumerate(scalars):
        sc[i] = _limbs4(int(s) % (1 << 256))
    return _run(pts, sc, window_size, n_threads)


def add_affine(p1: tuple[int, int], p2: tuple[int, int]) -> tuple[int, int]:
    """Affine sum of two partial MSM results (the join of a split)."""
    a = np.array(_limbs4(p1[0]) + _limbs4(p1[1]), dtype=np.uint64)
    b = np.array(_limbs4(p2[0]) + _limbs4(p2[1]), dtype=np.uint64)
    out = np.zeros(8, dtype=np.uint64)
    rc = load().point_add_affine(a.ctypes.data_as(_U64P), b.ctypes.data_as(_U64P),
                                 out.ctypes.data_as(_U64P))
    if rc != 0:
        raise RuntimeError(f"point_add_affine failed with code {rc}")
    return _xy(out)


def _be_rows_to_limbs4(be_rows: np.ndarray) -> np.ndarray:
    """[n, 8] big-endian u32 rows -> [n, 4] little-endian u64 limbs."""
    w = be_rows[:, ::-1].astype(np.uint64)  # LE word order
    return w[:, 0::2] | (w[:, 1::2] << np.uint64(32))


def msm_wire(
    points_be: np.ndarray,  # [n, 32] u32 BE rows: x || y || t || z (z == 1)
    scalars_be: np.ndarray,  # [n, 8] u32 BE rows
    window_size: int,
    n_threads: int = 0,
) -> tuple[int, int]:
    """Wire-format native MSM, marshalled by a few array operations. z is
    not read: the caller has checked that it is 1."""
    points_be = np.ascontiguousarray(points_be, dtype=np.uint32).reshape(-1, 32)
    scalars_be = np.ascontiguousarray(scalars_be, dtype=np.uint32).reshape(-1, 8)
    pts = np.empty((points_be.shape[0], 3, 4), dtype=np.uint64)
    for c in range(3):
        pts[:, c, :] = _be_rows_to_limbs4(points_be[:, 8 * c : 8 * c + 8])
    return _run(pts, _be_rows_to_limbs4(scalars_be), window_size, n_threads)


def resolved_threads(config: MSMConfig, co_compute: bool) -> int:
    """`cpu_threads`, or every hardware thread (all but one beside the
    GPU, so that the thread that queues the device work keeps a core)."""
    if config.cpu_threads is not None:
        return config.cpu_threads
    hw = os.cpu_count() or 1
    return max(1, hw - 1) if co_compute else hw


def msm_affine(points: Sequence[ExtPoint], scalars: Sequence[int],
               config: MSMConfig) -> tuple[int, int]:
    w = config.resolved_window_size_native(len(points))
    return msm_window_partial(points, scalars, w, resolved_threads(config, co_compute=False))
