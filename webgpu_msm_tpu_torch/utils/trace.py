"""Phase timing and tracing: the counterpart of the JAX package's
`utils/trace.py`.

Nested phase timers on the host clock with a summary table, and a
`torch.profiler` capture of the device timeline in place of the JAX
package's `xla_trace`.

    from webgpu_msm_tpu_torch.utils.trace import time_begin, time_end, phase

    time_begin("convert inputs")
    ...
    time_end("convert inputs")          # logs "convert inputs: 12.3 ms"

    with phase("device msm"):
        ...

    with profiler_trace("traces/msm"):  # traces/msm/trace.json, for Perfetto or chrome://tracing
        ...

A phase is a host clock: around work that the device runs later (copies
and kernels queued on a CUDA stream) it times the queueing, not the
device. Only a phase that ends in a synchronization, such as the fetch of
a result to the host, includes the device's time.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List

logger = logging.getLogger("webgpu_msm_tpu_torch")

_starts: Dict[str, float] = {}
_records: List[tuple[str, float]] = []
enabled = True


def time_begin(label: str) -> None:
    if enabled:
        _starts[label] = time.perf_counter()


def time_end(label: str) -> float:
    if not enabled or label not in _starts:
        return 0.0
    ms = (time.perf_counter() - _starts.pop(label)) * 1000
    _records.append((label, ms))
    logger.info("%s: %.1f ms", label, ms)
    return ms


@contextlib.contextmanager
def phase(label: str):
    time_begin(label)
    try:
        yield
    finally:
        time_end(label)


def records() -> List[tuple[str, float]]:
    return list(_records)


def reset() -> None:
    _starts.clear()
    _records.clear()


def summary() -> str:
    lines = [f"{label:32s} {ms:10.1f} ms" for label, ms in _records]
    return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Profile the block's host ops and device kernels with
    `torch.profiler` and write a Chrome trace (`trace.json`) to log_dir."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():  # the device timeline; the host's alone on a CPU-only build
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
