"""Co-compute: the native CPU engine and the GPU engine on one MSM at once.

The counterpart of the JAX package's `engines/hybrid_engine.py` (the
reference's cpuWorkRatio variant). The points are split at
n_cpu = int(n * cpu_work_ratio): one worker thread runs the native MSM on
the first n_cpu while the calling thread queues the GPU share on `device`
and waits for it (ctypes releases the interpreter lock inside the native
call, so the two overlap). The two partial results are joined with one
native affine add. Each engine resolves its own window: the native rule
for the CPU share, `resolved_wire_plan` for the GPU share.
"""
from __future__ import annotations

import concurrent.futures
from typing import Sequence

import numpy as np
import torch

from ..config import MSMConfig
from ..oracle.curve import ExtPoint
from . import cpu_engine, gpu_engine


def msm_affine(points: Sequence[ExtPoint], scalars: Sequence[int], config: MSMConfig,
               device: torch.device) -> tuple[int, int]:
    n = len(points)
    n_cpu = int(n * config.cpu_work_ratio)
    if n_cpu <= 0:
        return gpu_engine.msm_affine(points, scalars, config, device)
    if n_cpu >= n:
        return cpu_engine.msm_affine(points, scalars, config)
    w = config.resolved_window_size_native(n)
    n_threads = cpu_engine.resolved_threads(config, co_compute=True)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        cpu_future = pool.submit(cpu_engine.msm_window_partial, points[:n_cpu], scalars[:n_cpu],
                                 w, n_threads)
        gpu_result = gpu_engine.msm_affine(points[n_cpu:], scalars[n_cpu:], config, device)
        cpu_result = cpu_future.result()
    return cpu_engine.add_affine(cpu_result, gpu_result)


def msm_affine_wire(points_be: np.ndarray, scalars_be: np.ndarray, config: MSMConfig,
                    device: torch.device, z_checked: bool = False) -> tuple[int, int]:
    """Wire-format co-compute: [n, 32] BE point rows (z == 1) and [n, 8] BE
    scalar rows, split as arrays. `z_checked`: the caller has checked
    z == 1 (the API does); otherwise it is checked here, once for both
    shares."""
    rows = gpu_engine._wire_rows(points_be, "the hybrid wire path", z_checked)
    scalars_be = gpu_engine._scalar_rows(scalars_be)
    n = rows.shape[0]
    if scalars_be.shape[0] != n:
        raise ValueError(f"points/scalars length mismatch: {n} vs {scalars_be.shape[0]}")
    n_cpu = int(n * config.cpu_work_ratio)
    if n_cpu <= 0:
        return gpu_engine.msm_affine_wire(rows, scalars_be, config, device, True)
    w = config.resolved_window_size_native(n)
    if n_cpu >= n:
        return cpu_engine.msm_wire(rows, scalars_be, w,
                                   cpu_engine.resolved_threads(config, co_compute=False))
    n_threads = cpu_engine.resolved_threads(config, co_compute=True)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        cpu_future = pool.submit(cpu_engine.msm_wire, rows[:n_cpu], scalars_be[:n_cpu], w, n_threads)
        gpu_result = gpu_engine.msm_affine_wire(rows[n_cpu:], scalars_be[n_cpu:], config, device,
                                                True)
        cpu_result = cpu_future.result()
    return cpu_engine.add_affine(cpu_result, gpu_result)
