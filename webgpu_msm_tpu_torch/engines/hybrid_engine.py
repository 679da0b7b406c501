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

import numpy as np
import torch

from ..config import MSMConfig
from . import cpu_engine, gpu_engine


def msm_affine_wire(points_be: np.ndarray, scalars_be: np.ndarray, config: MSMConfig,
                    device: torch.device) -> tuple[int, int]:
    """Co-compute on wire rows, split as arrays: contiguous [n, 32] u32 BE
    point rows with z == 1 and [n, 8] BE scalar rows of the same n, as the
    API gives them."""
    n = points_be.shape[0]
    n_cpu = int(n * config.cpu_work_ratio)
    if n_cpu <= 0:
        return gpu_engine.msm_affine_wire(points_be, scalars_be, config, device)
    w = config.resolved_window_size_native(n)
    if n_cpu >= n:
        return cpu_engine.msm_wire(points_be, scalars_be, w,
                                   cpu_engine.resolved_threads(config, co_compute=False))
    n_threads = cpu_engine.resolved_threads(config, co_compute=True)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        cpu_future = pool.submit(cpu_engine.msm_wire, points_be[:n_cpu], scalars_be[:n_cpu], w,
                                 n_threads)
        gpu_result = gpu_engine.msm_affine_wire(points_be[n_cpu:], scalars_be[n_cpu:], config, device)
        cpu_result = cpu_future.result()
    return cpu_engine.add_affine(cpu_result, gpu_result)
