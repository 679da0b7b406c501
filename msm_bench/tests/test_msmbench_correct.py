"""`correct` comes out false for the control and for each fault a cell
can have, planted under the timed path; true for the program as it is.
Runs the rest of a run on the CPU (the program's plain versions), at a
size a test can hold; the harness's look for a card is skipped.

The faults: a batch stage that returns its bucket carry unchanged (a
step that returns its state unchanged); half of the scalars left out;
the answer altered where it is produced. One card: no exchange between
chips to leave out.
"""
import time

import pytest

from msm_bench import harness
from msm_bench.reference import control_entry
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.oracle import field as program_field

CELLS = {"web-msm.2p16": dict(points=[128], input_sets=1),
         "fixed-base.2p20-batch4": dict(points=[128], input_sets=2, msms_per_call=2)}


def run(cell_name, monkeypatch, seed=11, entry=None):
    monkeypatch.setattr(harness, "WARM_ROUNDS", 1)
    cell, _ = harness.load_cell(cell_name)
    cell.traffic = dict(cell.traffic, **CELLS[cell_name])
    if entry is not None:
        cell.entry = entry
    return harness.run_cell(cell, seed, 0.0, False, "cpu", time.perf_counter())


def _unchanged_carry(*args, **static):
    return args[2]


def _half_the_scalars(real):
    def stage(scalars_be, pad_to, device):
        kept = scalars_be.copy()
        kept[kept.shape[0] // 2:] = 0
        return real(kept, pad_to, device)
    return stage


def _altered_answer(real):
    def fetch(out, w):
        x, y = real(out, w)
        return x, (y + 1) % program_field.P
    return fetch


FAULTS = {
    "state_unchanged": lambda m: m.setattr(gpu_engine, "_fixed_batch_impl", _unchanged_carry),
    "half_left_out": lambda m: m.setattr(gpu_engine, "_stage_scalars", _half_the_scalars(gpu_engine._stage_scalars)),
    "answer_altered": lambda m: m.setattr(gpu_engine, "_fetch_affine", _altered_answer(gpu_engine._fetch_affine)),
}


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_sound_run_is_correct(cell_name, monkeypatch):
    r = run(cell_name, monkeypatch)
    assert r["correct"] and all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_control_is_not_correct(cell_name, monkeypatch):
    r = run(cell_name, monkeypatch, entry=control_entry)
    assert not r["correct"]
    assert r["checks"]["wrong_results"]["value"] == r["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_fault_is_not_correct(cell_name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run(cell_name, monkeypatch)
    assert not r["correct"]
    assert r["checks"]["wrong_results"]["value"] == r["attempted"] > 0
