"""The port's tooling against the JAX package's: `utils/trace.py`, the
`benchmark` harness and the root `bench_torch.py` (held against
`bench.py`). No JAX computation runs here: the JAX modules give inputs and
formats only.
"""
import contextlib
import csv
import importlib.util
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from webgpu_msm_tpu import benchmark as jbenchmark
from webgpu_msm_tpu.utils import trace as jtrace

from webgpu_msm_tpu_torch import MSMConfig, MSMPlan, benchmark, compute_msm
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.utils import trace

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

REPO = Path(__file__).resolve().parents[1]


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name.removesuffix(".py"), REPO / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def clean_trace():
    trace.reset()
    yield
    trace.reset()
    trace.enabled = True


def test_trace_records_nests_and_formats_as_jax(clean_trace, caplog):
    with caplog.at_level(logging.INFO, logger="webgpu_msm_tpu_torch"):
        with trace.phase("outer"):
            with trace.phase("inner"):
                pass
        trace.time_begin("manual")
        ms = trace.time_end("manual")
    assert [label for label, _ in trace.records()] == ["inner", "outer", "manual"]
    assert ms >= 0 and trace.records()[-1][1] == ms
    assert [r.getMessage().split(":")[0] for r in caplog.records] == ["inner", "outer", "manual"]
    assert trace.time_end("never begun") == 0.0
    records = [("convert inputs", 12.25), ("device msm (wire)", 3.5)]
    saved = list(jtrace._records)
    try:
        jtrace._records[:] = records
        trace._records[:] = records
        assert trace.summary() == jtrace.summary()
    finally:
        jtrace._records[:] = saved
    trace.reset()
    assert trace.records() == [] and trace.summary() == ""


def test_trace_disabled_records_nothing(clean_trace):
    trace.enabled = False
    with trace.phase("off"):
        pass
    assert trace.records() == [] and trace.time_end("off") == 0.0


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with trace.profiler_trace(str(tmp_path)):
        torch.ones(4).add_(1)
    assert (tmp_path / "trace.json").stat().st_size > 0


CALL_SPANS = {  # the program's spans of one call at n 16, w 8, one batch of 4 x 4, in the order they end
    "wire": ["check inputs (wire)", "slice/pad inputs (wire)",
             "stage wire_batch_w8_c4x4_s1: eager", "stage finish_w8_s1: eager", "queue stages",
             "fetch", "combine windows"],
    # lists fail the wire check, are marshalled to wire rows, then take the same road
    "lists": ["check inputs (wire)", "convert inputs", "slice/pad inputs (wire)",
              "stage wire_batch_w8_c4x4_s1: eager", "stage finish_w8_s1: eager", "queue stages",
              "fetch", "combine windows"],
    "plan": ["check inputs (wire)", "stage scalars (plan)",
             "stage fixed_batch_w8_c4x4_s1: eager", "stage finish_w8_s1: eager", "queue stages",
             "fetch", "combine windows"],
    "batch": (["check inputs (wire)"] * 2
              + ["stage scalars (plan)", "stage fixed_batch_w8_c4x4_s1: eager",
                 "stage finish_w8_s1: eager", "queue stages"] * 2
              + ["fetch", "combine windows"] * 2),
    # two batches of 2 x 4: each batch's rows are written, then its stage is
    # queued, in turns; the first queue makes the carry, the last the finish
    "wire-2-batches": ["check inputs (wire)",
                       "slice/pad inputs (wire)", "stage wire_batch_w8_c2x4_s1: eager", "queue stages",
                       "slice/pad inputs (wire)", "stage wire_batch_w8_c2x4_s1: eager",
                       "stage finish_w8_s1: eager", "queue stages", "fetch", "combine windows"],
    "plan-2-batches": ["check inputs (wire)",
                       "stage scalars (plan)", "stage fixed_batch_w8_c2x4_s1: eager", "queue stages",
                       "stage scalars (plan)", "stage fixed_batch_w8_c2x4_s1: eager",
                       "stage finish_w8_s1: eager", "queue stages", "fetch", "combine windows"],
}
CALL_COUNTS = {  # the counters after the same call: 64 bytes a point's x||y row, 32 a scalar row
    path: {trace.STAGED_BYTES: staged, trace.BATCH_STAGES: batches, trace.BATCHES_STREAMED: streamed,
           trace.SIGNED_REQUEUES: 0, trace.PARALLEL_BATCHES: 0}  # 16 rows: the copier works alone
    for path, (staged, batches, streamed) in {
        "wire": (16 * 96, 1, 0), "lists": (16 * 96, 1, 0), "plan": (16 * 32, 1, 0),
        "batch": (2 * 16 * 32, 2, 0), "wire-2-batches": (16 * 96, 2, 1),
        "plan-2-batches": (16 * 32, 2, 1)}.items()
}
CFG = MSMConfig(window_size=8, n_chunks=4, chunk_len=4)
CFG_2_BATCHES = MSMConfig(window_size=8, n_chunks=2, chunk_len=4)


def call_of(path):
    """A CPU call of `path` at n 16 and its expected results; a plan is
    built first, outside the call."""
    pw, sw, expected = benchmark._wire_case(16)
    cfg = CFG_2_BATCHES if path.endswith("-2-batches") else CFG
    path = path.removesuffix("-2-batches")
    if path == "wire":
        return lambda: [compute_msm(pw, sw, config=cfg, device="cpu")], [expected]
    if path == "lists":
        points, scalars, _ = benchmark._case(16)
        return lambda: [compute_msm(points, scalars, config=cfg, device="cpu")], [expected]
    plan = MSMPlan(pw, config=cfg, device="cpu")
    if path == "plan":
        return lambda: [plan.msm(sw)], [expected]
    return lambda: plan.msm_batch([sw, sw]), [expected] * 2


@pytest.mark.parametrize("path", sorted(CALL_SPANS))
def test_cpu_calls_record_the_jax_phases(clean_trace, path):
    """A wire call records the JAX engine's wire staging phase and the
    port's spans around it, a list call the same after its marshal, a plan job
    and a two-job `msm_batch` theirs for each job (the fetches after every
    job is queued), a two-batch wire call or plan job its staging and
    queueing spans in turns; then the counters that are not zero, at their
    totals."""
    call, expected = call_of(path)
    trace.reset()
    got = call()
    assert [(r.x, r.y) for r in got] == expected
    counted = [(label, n) for label, n in CALL_COUNTS[path].items() if n]
    assert [label for label, _ in trace.records()] == CALL_SPANS[path] + [label for label, _ in counted]
    assert trace.records()[len(CALL_SPANS[path]):] == counted and trace.counts() == CALL_COUNTS[path]


def wrap_phase_as_the_benchmark_does(monkeypatch):
    """`trace.phase` wrapped in a profiler range of its own, as
    `msm_bench/harness.py` wraps it in traced runs."""
    original = trace.phase

    @contextlib.contextmanager
    def phase(label):
        with torch.profiler.record_function(trace.RANGE_PREFIX + label), original(label):
            yield

    monkeypatch.setattr(trace, "phase", phase)


def identity_stages(monkeypatch):
    """The wire path's two stages made trivial (the carry passed on, the
    identity as every window sum), so that a profiled call records a few
    ops rather than the plain kernels' many: the call's result is then the
    identity."""
    def finish(carry):
        sums = torch.zeros((4, 16, carry.shape[2]), dtype=torch.int64)
        sums[1, 0] = sums[3, 0] = 1  # y = z = 1
        return sums

    monkeypatch.setattr(gpu_engine, "_wire_batch_impl", lambda xy, sc, carry, **static: carry)
    monkeypatch.setattr(gpu_engine, "_finish_impl", finish)


@pytest.mark.parametrize("wrapped", [False, True], ids=["plain", "phase_wrapped"])
def test_program_spans_are_profiler_ranges_once(clean_trace, wrapped, monkeypatch):
    """Under `torch.profiler` each span of a wire call is one range named
    "phase: " + its label, also with `trace.phase` wrapped in a range of
    its own; no range of a label lies inside another of the same label."""
    from torch.profiler import ProfilerActivity, profile

    if wrapped:
        wrap_phase_as_the_benchmark_does(monkeypatch)
    identity_stages(monkeypatch)
    call, _ = call_of("wire")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert [(r.x, r.y) for r in call()] == [(0, 1)]
    ranges = [e for e in prof.events() if e.name.startswith(trace.RANGE_PREFIX)]
    want = [trace.RANGE_PREFIX + label for label, _ in trace.records() if label not in trace.COUNTERS]
    assert sorted(e.name for e in ranges) == sorted(want) and len(want) == len(CALL_SPANS["wire"])
    for a in ranges:
        assert not any(b is not a and b.name == a.name and b.time_range.start <= a.time_range.start
                       and a.time_range.end <= b.time_range.end for b in ranges), a.name


def test_a_call_makes_no_range_with_no_profiler_on(clean_trace, monkeypatch):
    made = []

    def record_function(*args, **kwargs):
        made.append(args)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", record_function)
    assert not torch.autograd.profiler._is_profiler_enabled
    calls = [call_of(path) for path in ("wire", "plan")]
    trace.reset()
    for call, expected in calls:
        assert [(r.x, r.y) for r in call()] == expected
    spans = [label for label, _ in trace.records() if label not in trace.COUNTERS]
    assert made == [] and len(spans) == len(CALL_SPANS["wire"]) + len(CALL_SPANS["plan"])


def test_phase_is_the_host_clock_alone_and_span_adds_a_range(clean_trace):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.phase("host clock"):
            pass
        with trace.span("ranged"):
            pass
    names = [e.name for e in prof.events()]
    assert names.count("phase: ranged") == 1 and "phase: host clock" not in names
    assert [label for label, _ in trace.records()] == ["host clock", "ranged"]


def test_records_keep_the_newest_and_count_what_was_dropped(clean_trace, monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 4)
    for i in range(11):
        with trace.span(f"s{i}"):
            pass
    assert [label for label, _ in trace.records()] == ["s7", "s8", "s9", "s10"]
    assert trace.dropped() == 7 and len(trace._records) <= 2 * trace.MAX_RECORDS
    assert trace.summary().splitlines()[0].split()[0] == "s7"
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_benchmark_cases_match_jax():
    points, scalars, expected = benchmark._case(10, seed=7)
    jpoints, jscalars, jexpected = jbenchmark._case(10, seed=7)
    assert scalars == jscalars and expected == jexpected
    assert [(p.x, p.y, p.t, p.z) for p in points] == [(p.x, p.y, p.t, p.z) for p in jpoints]
    for ours, theirs in zip(benchmark._wire_case(10, seed=7), jbenchmark._wire_case(10, seed=7)):
        if isinstance(ours, np.ndarray):
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
        else:
            assert ours == theirs


def test_benchmark_run_rows_are_correct():
    rows = benchmark.run([6], ["gpu", "oracle", "cpu"], windows=[8, 9], device="cpu")
    assert [r["msmFunc"] for r in rows] == [f"{e}(w={w})" for e in ("gpu", "oracle", "cpu") for w in (8, 9)]
    assert all(r["correct"] and r["inputSize"] == 6 and set(r) == set(benchmark.FIELDS) for r in rows)


def test_benchmark_main_covers_both_digit_forms_into_csv(tmp_path):
    out = tmp_path / "rows.csv"
    argv = ["--sizes", "4", "--engines", "oracle,cpu", "--signed", "--unsigned", "--csv", str(out)]
    assert benchmark.main(argv) == 0
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == benchmark.FIELDS
    assert [r["msmFunc"] for r in rows] == ["oracle", "oracle unsigned", "cpu", "cpu unsigned"]
    assert all(r["correct"] == "True" and r["inputSize"] == "4" for r in rows)


def test_bench_torch_inputs_match_bench():
    ours, theirs = load_script("bench_torch.py"), load_script("bench.py")
    for a, b in zip(ours.build_inputs(16, seed=3), theirs.build_inputs(16, seed=3)):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    for a, b in zip(ours.build_wire_inputs(16, seed=3), theirs.build_wire_inputs(16, seed=3)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_bench_torch_baselines_are_cached_by_machine(tmp_path, monkeypatch):
    """A baseline is measured once per host, CPU count and card, and again
    for another card or a size it was not measured at."""
    bench = load_script("bench_torch.py")
    monkeypatch.setattr(bench, "BASELINE_CACHE", tmp_path / "baselines.json")
    measured = []
    for key, fn in (("python", "measure_python_baseline"), ("native_st", "measure_native_baseline"),
                    ("demox", "measure_demox_baseline")):
        monkeypatch.setattr(bench, fn, lambda n_pow, *a, _k=key: measured.append(_k) or
                            {"n": 1 << n_pow, "bit_exact": True, "points_per_s": 1.0})
    first = bench.get_baselines(4, None, "card A")
    assert measured == ["python", "native_st", "demox"] and first["machine"]["card"] == "card A"
    assert bench.get_baselines(4, None, "card A") == first and len(measured) == 3
    bench.get_baselines(5, None, "card A")
    bench.get_baselines(5, None, "card B")
    assert len(measured) == 9
