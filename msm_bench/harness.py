"""One run of one cell: set-up, warm-up, the measured window (or a traced
stretch), the comparison with the plain reference, and the result.

Everything that belongs to one cell is found by name:

- `BENCHMARK.json` `workloads[]`: the cell, its `config` and `traffic`;
- `configs/<config>.json`: the deployment and the `entry` it calls;
- `traffic/<traffic>.json`: the mix, read by the one generator below;
- `entries/<entry>.py`: `setup(inputs, device)` and `call(state, sets)`,
  one user call through the program's public API, returning each MSM's
  affine (x, y);
- `metrics/<name>.py`: `read(trace)`, one per-layer metric (None when
  it finds nothing to read), for each `per_layer` entry of the cell.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import trace_reader, yardstick
from .reference import expected, inputs as reference_inputs

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
BUILD_DIR = CHECKOUT / "build" / "msm_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "webgpu_msm_tpu")  # top-level module names
TRACE_SECONDS = 1.0  # a traced stretch: at least this long and one rotation of the input sets
CHECKED_ROWS = 8  # rows of the inputs checked against their logs in Python ints, each run
WARM_ROUNDS = 2  # calls of every input group before the window: captures, then replays
CLOSED_LOOP = "closed, one caller"  # the one loop the generator runs (traffic "loop")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    entry: object  # the module of entries/<entry>.py
    end_to_end: list  # the cell's end_to_end metric entries
    per_layer: list  # (name, unit, reader module) of the cell's per_layer metrics


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str) -> tuple[Cell, int]:
    """The cell named `name` in BENCHMARK.json, and the chips it asks for."""
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = json.loads((ROOT / "configs" / f"{work['config']}.json").read_text())
    traffic = json.loads((ROOT / "traffic" / f"{work['traffic']}.json").read_text())
    entry = load_module(ROOT / "entries" / f"{config['entry']}.py", f"msm_bench_entry_{config['entry']}")
    listed = lambda m: name in m.get("workloads", [name])
    per_layer = [(m["name"], m["unit"], load_module(ROOT / "metrics" / f"{m['name']}.py",
                                                    f"msm_bench_metric_{m['name']}"))
                 for m in bench["per_layer"] if listed(m)]
    cell = Cell(name, config, traffic, entry, [m for m in bench["end_to_end"] if listed(m)], per_layer)
    return cell, work["chips"]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _phases_as_ranges():
    """The program's phases (`utils/trace.phase`, host clocks with no
    position in time) also as profiler ranges, so that the trace can say
    what the host was doing while the device was idle. Only while traced."""
    from torch.profiler import record_function
    from webgpu_msm_tpu_torch.utils import trace as program_trace

    original = program_trace.phase

    @contextlib.contextmanager
    def phase(label):
        with record_function(trace_reader.PHASE + label), original(label):
            yield

    program_trace.phase = phase
    try:
        yield
    finally:
        program_trace.phase = original


def _groups(cell: Cell, inputs) -> list:
    per_call = cell.traffic["msms_per_call"]
    sets = inputs.sets
    if len(sets) % per_call:
        raise ValueError(f"{cell.name}: {len(sets)} input sets do not split into calls of {per_call}")
    return [sets[i:i + per_call] for i in range(0, len(sets), per_call)]


def _loop(cell: Cell, state, groups: list, seconds: float, min_calls: int, span: bool) -> tuple[list, float]:
    """Closed loop, one caller: calls back to back, rotating over the
    groups, until `seconds` have passed and `min_calls` are made. Returns
    [(group index, start, end, results)] and the window's length (the
    first call's start to the last one's end)."""
    calls = []
    ctx = (lambda: torch.profiler.record_function(trace_reader.CALL_SPAN)) if span else contextlib.nullcontext
    start = time.perf_counter()
    while True:
        g = len(calls) % len(groups)
        with ctx():
            t0 = time.perf_counter()
            results = cell.entry.call(state, groups[g])
            t1 = time.perf_counter()
        calls.append((g, t0, t1, results))
        if t1 - start >= seconds and len(calls) >= min_calls:
            return calls, t1 - start


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
             stderr=sys.stderr) -> dict:
    """One run; returns the result line's object."""
    device = torch.device(device)
    marks = [("start", time.perf_counter())]
    traffic = cell.traffic
    if traffic["loop"] != CLOSED_LOOP:
        raise ValueError(f"{cell.name}: the generator runs a {CLOSED_LOOP!r} loop, not {traffic['loop']!r}")
    sizes = traffic["points"]
    fixed = cell.config["bases"] == "fixed"
    if fixed and len(set(sizes)) != 1:
        raise ValueError(f"{cell.name}: fixed bases take one size, not {sizes}")
    inputs = reference_inputs.make_inputs(seed, sizes, traffic["input_sets"], fixed,
                                          traffic.get("scalar_bits", 253), device)
    if device.type == "cuda":  # the inputs' scratch must not count toward the program's peak
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("inputs", time.perf_counter()))
    groups = _groups(cell, inputs)
    state = cell.entry.setup(inputs, device)
    marks.append(("entry set-up", time.perf_counter()))
    for g in groups * WARM_ROUNDS:  # every shape and every host buffer: the window only replays
        cell.entry.call(state, g)
    _sync(device)
    marks.append(("warm calls", time.perf_counter()))
    mad_rate = None
    if trace and device.type == "cuda":
        mad_rate = yardstick.mad_rate_per_s(yardstick.build_mad_probe(BUILD_DIR))
        marks.append(("multiply-rate probe", time.perf_counter()))
    setup_s = time.perf_counter() - t_process
    print("set-up s: imports " + f"{marks[0][1] - t_process:.3f}, " + ", ".join(
        f"{name} {t - marks[i][1]:.3f}" for i, (name, t) in enumerate(marks[1:])), file=stderr)

    if trace:
        calls, tr = _traced(cell, state, groups, min(seconds, TRACE_SECONDS), device)
        tr.mad_rate = mad_rate
        tr.shape = yardstick.pipeline_shape(sizes[0], _wire_plan(sizes[0])) if len(set(sizes)) == 1 else {}
    else:
        calls, window_s = _loop(cell, state, groups, seconds, 1, False)
    _sync(device)

    memory_peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    del state  # the program's state is freed before the reference runs

    t_check = time.perf_counter()
    checks = _check(inputs, groups, calls, seed, device)
    print(f"reference check s: {time.perf_counter() - t_check:.3f}", file=stderr)
    msms = sum(len(c[3]) for c in calls)
    result = {
        "correct": all(checks[k]["value"] == 0 for k in ("wrong_results", "missing_results", "bad_inputs")),
        "attempted": msms,
        "failed": 0,
        "metrics": {},
        "device": _device_info(device, memory_peak),
    }
    if trace:
        _per_layer(cell, tr, result, stderr)
    else:
        values = end_to_end_values(calls, window_s, setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        lat = np.array([(c[2] - c[1]) * 1e3 for c in calls])
        print(f"samples: {len(calls)} calls, {msms} MSMs in {window_s:.3f} s; call ms min, quartiles, max "
              f"{' '.join(f'{v:.3f}' for v in np.percentile(lat, [0, 25, 50, 75, 100]))}; "
              f"peak reserved device memory {memory_peak} bytes", file=stderr)
    result["checks"] = checks
    return result


def _traced(cell: Cell, state, groups: list, seconds: float, device: torch.device):
    """The loop under the profiler, at least one rotation of the groups:
    (calls, the Trace that the per-layer readers take)."""
    from torch.profiler import ProfilerActivity, profile
    from webgpu_msm_tpu_torch.ops.kernels import padd_kernels
    from webgpu_msm_tpu_torch.utils import trace as program_trace

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    program_trace.reset()
    before = dict(padd_kernels.launches)
    with _phases_as_ranges(), profile(activities=activities) as prof:
        calls, _ = _loop(cell, state, groups, seconds, len(groups), True)
        _sync(device)
    launches = {k: padd_kernels.launches[k] - before[k] for k in before}
    phases: dict[str, list] = {}
    for label, ms in program_trace.records():
        phases.setdefault(label, []).append(ms)
    events = prof.events()
    spans = trace_reader.call_spans(events)
    if len(spans) != len(calls):
        raise RuntimeError(f"{len(spans)} call spans recorded for {len(calls)} calls")
    return calls, trace_reader.from_profile(
        events, [(s, e, len(c[3])) for (s, e), c in zip(spans, calls)], phases=phases,
        launches={k: v for k, v in launches.items() if v}, mad_rate=None, shape={})


def _per_layer(cell: Cell, tr, result: dict, stderr) -> None:
    """The cell's per-layer metrics, the device's busy time and the
    breakdown into the result; records against launches on stderr."""
    for name, unit, reader in cell.per_layer:
        value = reader.read(tr)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": unit}
    busy = trace_reader.busy_us(tr) * 1e-6
    lo, hi = tr.window
    if busy > 0:
        result["device"].update(busy_s=busy, window_s=(hi - lo) * 1e-6)
        result["breakdown"] = trace_reader.breakdown(tr)
    print(f"traced: {len(tr.calls)} calls, {tr.msms} MSMs in {(hi - lo) * 1e-6:.3f} s; "
          f"mad.lo.u32 rate {tr.mad_rate}; device records {len(tr.device)}", file=stderr)
    print("kernel records by name against the program's launch counts: " + json.dumps(
        {k: {"profiled": tr.profiled.get(k + "_kernel", 0), "launches": v}
         for k, v in sorted(tr.launches.items())}), file=stderr)


def end_to_end_values(calls: list, window_s: float, setup_s: float) -> dict:
    """msm_ms: the window's length over the MSMs completed in it (each job
    of a batch call is one MSM); call_p95_ms: the 95th percentile (linear
    between order statistics) of every call's latency, from its start to
    its affine results on the host."""
    msms = sum(len(c[3]) for c in calls)
    return {"setup_s": setup_s, "msm_ms": window_s * 1e3 / msms,
            "call_p95_ms": float(np.percentile([(c[2] - c[1]) * 1e3 for c in calls], 95))}


class ForbiddenImport(RuntimeError):
    def __init__(self, found: list[str]):
        super().__init__(f"modules loaded in the measured process: {', '.join(found)}")
        self.found = found


def _wire_plan(n: int):
    from webgpu_msm_tpu_torch import MSMConfig

    return MSMConfig().resolved_wire_plan(n)


def _device_info(device: torch.device, memory_peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": memory_peak}


def _check(inputs, groups: list, calls: list, seed: int, device: torch.device) -> dict:
    """Every result of the window against the plain reference; the inputs'
    rows, a sample drawn from the seed, against their logs."""
    want: dict[int, tuple] = {}
    wrong = missing = 0
    for g, _, _, results in calls:
        sets = groups[g]
        missing += max(len(sets) - len(results), 0)
        for s, got in zip(sets, results):
            if id(s) not in want:
                want[id(s)] = expected.expected_result(inputs.k0, s, device)
            wrong += tuple(got) != want[id(s)]
    first = inputs.sets[0]
    rows = np.random.default_rng(seed).choice(len(first.chain_index), size=min(CHECKED_ROWS, len(first.chain_index)),
                                              replace=False)
    bad = expected.points_on_chain(inputs.k0, first, rows)
    return {"wrong_results": {"value": wrong, "limit": 0},
            "missing_results": {"value": missing, "limit": 0},
            "bad_inputs": {"value": bad, "limit": 0}}
