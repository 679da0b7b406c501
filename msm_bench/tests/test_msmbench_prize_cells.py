"""The cells of the ZPrize 2022 deployment at its published 2^26 bases and
of the ZPrize 2023 web task's scored mix: each loads by name, and a run on
the CPU, its traffic cut to a size a test can hold, is `correct`; its
traced run gives the readers of the program's counters what they read.
The readers (`metrics/stage_gbps.py`, `metrics/batch_replay_ms.py`) on a
synthetic trace: their reckoned values, and None where the program has no
counter, as a program before them has none."""
import time

import pytest
import torch

from msm_bench import harness
from msm_bench.tests.test_msmbench_metrics import METRICS, _trace
from webgpu_msm_tpu_torch.engines import gpu_engine

CELLS = {  # cell -> its config, traffic, entry, and the cut that a CPU run takes
    "fixed-base.2p26-batch4": ("zprize22-fixed-base-2p26", [1 << 26], "msm_plan",
                               dict(points=[128], input_sets=4)),
    "web-msm.mix": ("zprize23-web-msm", [1 << p for p in range(16, 21)], "compute_msm",
                    dict(points=[64, 128], input_sets=2)),
}
READERS = {
    "fixed-base.2p26-batch4": ["stage_gbps", "batch_replay_ms"],
    "web-msm.mix": ["stage_gbps"],
}


def metric(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_prize_metric_{name}")


def run(cell_name, monkeypatch, trace, seed=2**33 + 5):
    monkeypatch.setattr(harness, "WARM_ROUNDS", 1)
    cell, _ = harness.load_cell(cell_name)
    cell.traffic = dict(cell.traffic, **CELLS[cell_name][3])
    return harness.run_cell(cell, seed, 0.0, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_cell_loads_by_name(cell_name):
    config, points, entry, _ = CELLS[cell_name]
    cell, chips = harness.load_cell(cell_name)
    assert chips == 1 and cell.config["name"] == config and cell.config["entry"] == entry
    assert cell.traffic["points"] == points and cell.config["reduced"] == []
    assert len(cell.traffic["points"]) == 1 or cell.traffic["input_sets"] % len(points) == 0
    assert {m["name"] for m in cell.end_to_end} == {"msm_ms", "setup_s"}
    assert [name for name, _, _ in cell.per_layer] == READERS[cell_name]


def test_the_2p26_config_is_the_published_deployment():
    cell, _ = harness.load_cell("fixed-base.2p26-batch4")
    assert cell.config["bases_count"] == cell.config["published"]["bases_count"] == 1 << 26
    assert cell.traffic["msms_per_call"] == 4 and cell.traffic["input_sets"] == 8


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_cut_run_is_correct(cell_name, monkeypatch):
    r = run(cell_name, monkeypatch, trace=False)
    assert r["correct"] and all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"msm_ms", "setup_s"}


def identity_stages(monkeypatch):
    """The batch stages made to pass the carry on and the finish to give
    the identity as every window sum, so that a profiled run records a few
    ops rather than the plain kernels' many (its results are then wrong)."""
    def finish(carry):
        sums = torch.zeros((4, 16, carry.shape[2]), dtype=torch.int64)
        sums[1, 0] = sums[3, 0] = 1  # y = z = 1
        return sums

    for impl in ("_wire_batch_impl", "_fixed_batch_impl"):
        monkeypatch.setattr(gpu_engine, impl, lambda rows, sc, carry, **static: carry)
    monkeypatch.setattr(gpu_engine, "_finish_impl", finish)


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_traced_cut_run_reads_the_staging_counter(cell_name, monkeypatch):
    """The counters reach the readers through the harness as it is: the
    staged bytes over the staging spans on the CPU; no device record, so
    no batch replay time."""
    identity_stages(monkeypatch)
    r = run(cell_name, monkeypatch, trace=True)
    assert r["metrics"]["stage_gbps"]["value"] > 0 and r["metrics"]["stage_gbps"]["unit"] == "GB/s"
    assert "batch_replay_ms" not in r["metrics"]


def test_stage_gbps_is_counted_bytes_over_the_staging_spans():
    read = metric("stage_gbps").read
    phases = {"bytes staged": [3e9], "slice/pad inputs (wire)": [500.0], "stage scalars (plan)": [250.0, 250.0],
              "queue stages": [99.0]}
    assert read(_trace(phases=phases)) == pytest.approx(3.0)  # 3e9 bytes in 1 s of staging spans
    assert read(_trace(phases={"bytes staged": [6e8], "stage scalars (plan)": [100.0] * 4})) == pytest.approx(1.5)


def test_batch_replay_ms_is_the_batch_stage_over_the_counted_calls():
    tr = _trace(phases={"batch stages queued": [6]})
    # batch_stage_ms: the scan, 20 us mean x 4 launches, and the sort's 10 us; the finish's excluded
    assert metric("batch_stage_ms").read(tr) * tr.msms == pytest.approx(0.09)
    assert metric("batch_replay_ms").read(tr) == pytest.approx(0.09 / 6)


@pytest.mark.parametrize("phases", [
    {"slice/pad inputs (wire)": [4.0], "stage scalars (plan)": [2.0]},  # a program with no counters
    {"bytes staged": [4096], "queue stages": [1.0]},  # counted bytes, no staging span
], ids=["no_counter", "no_span"])
def test_stage_gbps_finds_nothing_without_its_counter_and_spans(phases):
    assert metric("stage_gbps").read(_trace(phases=phases)) is None


@pytest.mark.parametrize("kw", [dict(phases={"queue stages": [1.0]}),  # no counter
                                dict(phases={"batch stages queued": [6]}, device=[])],  # no device record
                         ids=["no_counter", "no_device_record"])
def test_batch_replay_ms_finds_nothing_without_its_counter_and_records(kw):
    assert metric("batch_replay_ms").read(_trace(**kw)) is None
