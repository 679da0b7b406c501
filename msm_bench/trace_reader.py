"""What a traced stretch of calls recorded, in the form the per-layer
metric readers (`metrics/<name>.py`) take, and the reductions they share.

The profiler gives host ranges (the benchmark's call spans, the
program's phases, PyTorch ops, CUDA runtime calls) and device records
(kernels, copies, memsets) on one clock, in microseconds.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

CALL_SPAN = "msm_bench.call"
PHASE = "phase: "  # the prefix of the program's phases among the host ranges
# CUDA runtime calls that launch a kernel or a graph or queue a copy or a
# memset (chip_smoke.py's profile_counts counts the same).
RUNTIME_WORDS = ("Launch", "Memcpy", "Memset")


@dataclass
class DeviceRecord:
    name: str  # the kernel's symbol, or "Memcpy ..." / "Memset ..."
    start: float  # us
    end: float


@dataclass
class HostRange:
    name: str
    start: float
    end: float


@dataclass
class Trace:
    calls: list  # [(start us, end us, MSMs)] of each traced call
    device: list  # [DeviceRecord], by start
    host: list  # [HostRange] of the calling thread
    runtime_calls: int  # CUDA runtime launch / graph-launch / copy / memset calls
    phases: dict  # program phase -> [ms] of each occurrence in the stretch
    launches: dict  # kernel -> launches the program counted over the stretch
    shape: dict  # yardstick.pipeline_shape of one MSM
    mad_rate: float | None  # mad.lo.u32 a second, measured in this run
    profiled: dict = field(default_factory=dict)  # kernel -> records the profiler kept

    @property
    def msms(self) -> int:
        return sum(c[2] for c in self.calls)

    @property
    def window(self) -> tuple[float, float]:
        return self.calls[0][0], self.calls[-1][1]


def symbol(name: str) -> str:
    """A kernel's name without its argument list where it has one
    (`name(args)`); templated and namespaced names stay whole."""
    m = re.match(r"(\w+)\(", name)
    return m.group(1) if m else name


def call_spans(events) -> list:
    """[(start, end)] of the benchmark's call spans on the host."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end) for e in events
            if e.name == CALL_SPAN and e.device_type == DeviceType.CPU]


def from_profile(events, calls: list, **rest) -> Trace:
    """A Trace from `torch.profiler.profile(...).events()`."""
    from torch.autograd import DeviceType

    device, host, runtime = [], [], 0
    call_threads = {e.thread for e in events if e.name == CALL_SPAN and e.device_type == DeviceType.CPU}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # user ranges are mirrored on the device's timeline: not device work
            if not (e.is_user_annotation or e.name == CALL_SPAN or e.name.startswith(PHASE)):
                device.append(DeviceRecord(symbol(e.name), e.time_range.start, e.time_range.end))
        elif e.thread in call_threads:
            host.append(HostRange(e.name, e.time_range.start, e.time_range.end))
            if e.name.startswith("cu") and any(w in e.name for w in RUNTIME_WORDS):
                runtime += 1
    device.sort(key=lambda r: r.start)
    host.sort(key=lambda r: (r.start, -r.end))
    profiled: dict[str, int] = {}
    for r in device:
        profiled[r.name] = profiled.get(r.name, 0) + 1
    return Trace(calls=calls, device=device, host=host, runtime_calls=runtime,
                 profiled=profiled, **rest)


def busy_intervals(tr: Trace) -> list:
    """The union of device activity inside the traced window, as sorted
    disjoint [start, end] intervals."""
    lo, hi = tr.window
    out: list = []
    for r in tr.device:
        s, e = max(r.start, lo), min(r.end, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr))


def idle_gaps(tr: Trace) -> list:
    """[(start, end)] of the traced window where the device ran nothing."""
    lo, hi = tr.window
    gaps, t = [], lo
    for s, e in busy_intervals(tr):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def kernel_us(tr: Trace, name: str) -> float | None:
    """Device time of one hand-written kernel over the stretch: the mean
    of its records times the launches the program counted, so that a
    record the profiler drops from a graph replay does not lower it. None
    without a record."""
    times = [r.end - r.start for r in tr.device if r.name == name]
    if not times:
        return None
    launches = tr.launches.get(name[: -len("_kernel")], len(times)) if name.endswith("_kernel") else len(times)
    return sum(times) / len(times) * launches


def host_labels(tr: Trace, times: list) -> list:
    """What the calling thread was doing at each of the sorted times: the
    outermost range that covers it, the program's phases inside that,
    and the innermost range, joined by " > "."""
    labels, active, i = [], [], 0
    for t in times:
        while i < len(tr.host) and tr.host[i].start <= t:
            active.append(tr.host[i])
            i += 1
        active = [h for h in active if h.end > t]
        if not active:
            labels.append("(outside any range)")
            continue
        names = [active[0].name] + [h.name for h in active[1:-1] if h.name.startswith(PHASE)]
        if len(active) > 1:
            names.append(active[-1].name)
        labels.append(" > ".join(names))
    return labels


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists; copies
    and memsets keep theirs ("Memcpy HtoD (Pinned -> Device)")."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", name, maxsplit=1)[0] or name


def breakdown(tr: Trace, top: int = 10, step_us: float = 50.0) -> dict:
    """The device operations that took most time, and the device's idle
    time by what the host was doing under it, in seconds. A gap is
    sampled every `step_us` and each sample labelled by `host_labels`."""
    ops: dict[str, float] = {}
    for r in tr.device:
        k = short_name(r.name)
        ops[k] = ops.get(k, 0.0) + (r.end - r.start) * 1e-6
    times, weights = [], []
    for s, e in idle_gaps(tr):
        n = max(1, int((e - s) // step_us))
        times += [s + (i + 0.5) * (e - s) / n for i in range(n)]
        weights += [(e - s) / n * 1e-6] * n
    gaps: dict[str, float] = {}
    for label, w in zip(host_labels(tr, times), weights):
        gaps[label] = gaps.get(label, 0.0) + w
    best = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": best(ops), "idle_gaps": best(gaps)}
