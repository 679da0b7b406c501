"""The port's tooling against the JAX package's: `utils/trace.py`, the
`benchmark` harness and the root `bench_torch.py` (held against
`bench.py`). No JAX computation runs here: the JAX modules give inputs and
formats only.
"""
import csv
import importlib.util
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from webgpu_msm_tpu import benchmark as jbenchmark
from webgpu_msm_tpu.utils import trace as jtrace

from webgpu_msm_tpu_torch import MSMConfig, benchmark, compute_msm
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


def test_cpu_calls_record_the_jax_phases(clean_trace):
    """A wire call records the JAX engine's two wire phases, a list call its
    two planes phases."""
    pw, sw, expected = benchmark._wire_case(16)
    points, scalars, _ = benchmark._case(16)
    cfg = MSMConfig(window_size=8, n_chunks=4, chunk_len=4)
    got = compute_msm(pw, sw, config=cfg, device="cpu")
    assert [label for label, _ in trace.records()] == ["slice/pad inputs (wire)", "device msm (wire)"]
    trace.reset()
    assert compute_msm(points, scalars, config=cfg, device="cpu") == got
    assert [label for label, _ in trace.records()] == ["convert inputs", "device msm"]
    assert (got.x, got.y) == expected


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
