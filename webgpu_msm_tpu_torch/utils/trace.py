"""Phase timing and tracing: the counterpart of the JAX package's
`utils/trace.py`.

Nested phase timers on the host clock with a summary table, and a
`torch.profiler` capture of the device timeline in place of the JAX
package's `xla_trace`.

    from webgpu_msm_tpu_torch.utils.trace import time_begin, time_end, phase, span

    time_begin("convert inputs")
    ...
    time_end("convert inputs")          # logs "convert inputs: 12.3 ms"

    with phase("device msm"):           # the host clock alone
        ...

    with span("fetch"):                 # the host clock, and a profiler range
        ...

    with profiler_trace("traces/msm"):  # traces/msm/trace.json, for Perfetto or chrome://tracing
        ...

A phase is a host clock: around work that the device runs later (copies
and kernels queued on a CUDA stream) it times the queueing, not the
device. Only a phase that ends in a synchronization, such as the fetch of
a result to the host, includes the device's time.

The program's call sites use `span`: a phase that, while a
`torch.profiler` session records, is also a profiler range named
`RANGE_PREFIX + label`, on the clock of the profiler's kernel, copy and
memset records, so that every idle stretch of the device can be put down
to what the host was doing. With no profiler on, a span creates no range.
`phase` stays the host clock alone: a caller that wraps it in a range of
its own gets no second range from the program, which never calls it. No
span nests inside another of the same label (the timers are keyed by
label). The spans of one call or plan job, in order:

- "check inputs (wire)": validation only, once a job, in the API
  (`api._wire_inputs`, the z check; `MSMPlan._job_scalars`); the engines
  check nothing again;
- "convert inputs", only for a job that fails that check: its
  normalization and marshal to wire rows on the host (`api._job_rows`);
- then, batch by batch, alternating and never nested:
  - "slice/pad inputs (wire)": the batch's x||y and scalar rows written
    into the job's pinned buffer (the wire path), or "stage scalars
    (plan)": the batch's scalar rows (the plan); with signed digits, the
    batch's signed-digit test on the rows just written;
  - "queue stages": the batch's stage call, queued, not waited for; the
    first also makes the identity carry, the last also queues the finish;
    inside it one "stage <name>: <outcome>" for each
    `utils/cache.stage_call`, the outcome `replay`, `capture` or `eager`.

  So a job of k batches records k of each, in turns, and a one-batch job
  one of each. A job whose scalars fail the signed-digit test (one at or
  above 2^254) writes its remaining batches without queueing them, each
  under the staging span, then records one "queue stages" that queues the
  whole job again on unsigned digits, from a fresh identity carry;
- "fetch": the host waiting for the device and the device-to-host copy
  (for a job of a batch, the wait for the copy queued behind its finish
  stage, `gpu_engine._HostCopy`);
- "combine windows": the window sums to points, their combination and
  the affine result, in Python integers.

Set-up has one span: "build plan", a `WirePlan`'s staging of the bases'
x||y rows and their conversion to the resident rows (after "check inputs
(wire)", or "convert inputs" for bases that need the marshal).

Five counters (`count`), each one integer add, say how much work the spans
cover:

- `STAGED_BYTES`, "bytes staged": the bytes written into host tensors for
  the device (pinned on a GPU) by the wire path's and the plan's staging,
  counted a batch at a time (`gpu_engine._Staged.rows`);
- `BATCH_STAGES`, "batch stages queued": the batch-stage calls queued
  (`wire_batch`, `fixed_batch`; `batch_planes` on the device-resident
  entry, `gpu_engine._device_msm`), one a batch of a job, and
  one more a batch of a job queued again on unsigned digits;
- `BATCHES_STREAMED`, "batches streamed": the batches of a wire call or
  plan job queued before the job's last batch was written, k - 1 a job of
  k batches;
- `SIGNED_REQUEUES`, "signed re-queues": the jobs queued again on unsigned
  digits after a batch failed the signed-digit test;
- `PARALLEL_BATCHES`, "batches staged in parallel": the writes of
  `gpu_engine._Staged.rows` (a batch's x||y or scalar rows, or a plan's
  bases) that the row copier shared with its pool of workers
  (`runtime/rows.py`, from `PARALLEL_ROWS` rows on).

`records()` keeps the newest `MAX_RECORDS` (label, ms) pairs of the spans,
then one (label, total) for each counter that is not zero; `dropped()`
counts the span records let go since the last `reset()`, which also
zeroes the counters.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List

import torch

logger = logging.getLogger("webgpu_msm_tpu_torch")

MAX_RECORDS = 1 << 16
RANGE_PREFIX = "phase: "
STAGED_BYTES = "bytes staged"
BATCH_STAGES = "batch stages queued"
BATCHES_STREAMED = "batches streamed"
SIGNED_REQUEUES = "signed re-queues"
PARALLEL_BATCHES = "batches staged in parallel"
COUNTERS = (STAGED_BYTES, BATCH_STAGES, BATCHES_STREAMED, SIGNED_REQUEUES, PARALLEL_BATCHES)

_starts: Dict[str, float] = {}
_records: List[tuple[str, float]] = []
_dropped = 0  # records let go from the front of `_records`
_counts: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
enabled = True


def time_begin(label: str) -> None:
    if enabled:
        _starts[label] = time.perf_counter()


def time_end(label: str) -> float:
    global _dropped
    if not enabled or label not in _starts:
        return 0.0
    ms = (time.perf_counter() - _starts.pop(label)) * 1000
    if len(_records) >= 2 * MAX_RECORDS:  # let the oldest go in bulk, not one a record
        del _records[:MAX_RECORDS]
        _dropped += MAX_RECORDS
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


@contextlib.contextmanager
def span(label: str):
    """A phase, and a profiler range `RANGE_PREFIX + label` while a
    profiler records."""
    with (torch.autograd.profiler.record_function(RANGE_PREFIX + label)
          if torch.autograd.profiler._is_profiler_enabled else contextlib.nullcontext()):
        time_begin(label)
        try:
            yield
        finally:
            time_end(label)


def count(label: str, n: int) -> None:
    """Add n to the counter `label`, one of `COUNTERS`."""
    if enabled:
        _counts[label] += n


def counts() -> Dict[str, int]:
    """Each counter's total since the last `reset()`."""
    return dict(_counts)


def records() -> List[tuple]:
    """The newest `MAX_RECORDS` (label, ms) pairs of the spans, oldest
    first, then (label, total) of each counter that is not zero."""
    return _records[-MAX_RECORDS:] + [(label, n) for label, n in _counts.items() if n]


def dropped() -> int:
    """Records let go since the last `reset()`: all but the newest
    `MAX_RECORDS`."""
    return _dropped + max(len(_records) - MAX_RECORDS, 0)


def reset() -> None:
    global _dropped
    _starts.clear()
    _records.clear()
    _dropped = 0
    _counts.update(dict.fromkeys(COUNTERS, 0))


def summary() -> str:
    lines = [f"{label:32s} {ms:10.1f} ms" for label, ms in _records[-MAX_RECORDS:]]
    lines += [f"{label:32s} {n:10d}" for label, n in _counts.items() if n]
    return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Profile the block's host ops and device kernels with
    `torch.profiler` and write a Chrome trace (`trace.json`) to log_dir."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():  # the device timeline; the host's alone on a CPU-only build
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
