"""Streamed staging on the CPU: a wire call or plan job writes its rows
into its host buffer a batch at a time and queues each batch's stage as
soon as the batch is written, with the signed-digit test made batch by
batch as the rows are written.

Held against the benchmark's plain PyTorch reference (`msm_bench/reference/`)
at 1, 2, 4 and 41 batches, for one MSM and for an `msm_batch` of two; a
scalar at or above 2^254, which signed digits cannot take, in the first
batch, the last, or one job of two, still gives the exact result, the job
queued again on unsigned digits. The counters "batches streamed", "signed
re-queues", "bytes staged" and "batch stages queued" are held to their
reckoned values.
"""
import numpy as np
import pytest

from msm_bench.reference import expected, inputs as reference_inputs
from webgpu_msm_tpu_torch import MSMConfig, MSMPlan, compute_msm, compute_msm_batch
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.utils import trace

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

SEED = 2**42 + 23
BATCH = 4  # points a batch: n_chunks 2 x chunk_len 2
CFG = MSMConfig(window_size=8, n_chunks=2, chunk_len=2)
UNSIGNED = MSMConfig(window_size=8, n_chunks=2, chunk_len=2, signed_digits=False)
BYTES_A_ROW = {"wire": 96, "plan": 32}  # x || y and scalar rows; a plan job stages its scalars
TOO_BIG = np.array([0x40000000] + [0] * 7, dtype=np.uint32)  # 2^254: past what signed digits take


def n_points(batches: int) -> int:
    """The last batch holds 2 points and 2 rows of padding."""
    return (batches - 1) * BATCH + 2


def input_sets(batches: int, path: str):
    """Two input sets of `n_points(batches)`; a plan's share one point array."""
    return reference_inputs.make_inputs(SEED + batches, [n_points(batches)], 2, path == "plan", 253, "cpu")


def reference(inputs, sets) -> list:
    return [expected.expected_result(inputs.k0, s, "cpu") for s in sets]


def run(path: str, sets, config: MSMConfig = CFG) -> list:
    """The MSMs of `sets` through the path: one call for one set, else an
    `msm_batch` (a plan built first, outside the counted call)."""
    if path == "wire":
        if len(sets) == 1:
            got = [compute_msm(sets[0].points, sets[0].scalars, config=config, device="cpu")]
        else:
            got = compute_msm_batch([s.points for s in sets], [s.scalars for s in sets],
                                    config=config, device="cpu")
    else:
        plan = MSMPlan(sets[0].points, config=config, device="cpu")
        trace.reset()
        got = ([plan.msm(sets[0].scalars)] if len(sets) == 1
               else plan.msm_batch([s.scalars for s in sets]))
    return [(r.x, r.y) for r in got]


def plan_msm(plan: MSMPlan, scalars) -> list:
    r = plan.msm(scalars)
    return [(r.x, r.y)]


def counted(path: str, batches: int, jobs: int, streamed: int, requeued: int, stages: int,
            parallel: int = 0) -> dict:
    """The counters' reckoned values; batches of `BATCH` rows lie below the
    row copier's parallel bound, so by default none is shared with its pool."""
    return {trace.STAGED_BYTES: jobs * batches * BATCH * BYTES_A_ROW[path], trace.BATCH_STAGES: stages,
            trace.BATCHES_STREAMED: streamed, trace.SIGNED_REQUEUES: requeued,
            trace.PARALLEL_BATCHES: parallel}


@pytest.fixture
def clean_trace():
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("jobs", [1, 2], ids=["msm", "msm_batch_of_2"])
@pytest.mark.parametrize("batches", [1, 2, 4, 41])
@pytest.mark.parametrize("path", ["wire", "plan"])
def test_streamed_jobs_match_the_reference(clean_trace, path, batches, jobs):
    inputs = input_sets(batches, path)
    sets = inputs.sets[:jobs]
    trace.reset()
    assert run(path, sets) == reference(inputs, sets)
    # every batch but a job's last is queued before the job's last rows are
    # written; the bytes staged are the whole padded job's, as one write gave
    assert trace.counts() == counted(path, batches, jobs, jobs * (batches - 1), 0, jobs * batches)


def event_log(monkeypatch) -> list:
    """Record, in order, each batch's write ("write <lo>") and each stage
    queued ("stage <name>")."""
    log = []
    rows, call_stage = gpu_engine._Staged.rows, gpu_engine._call_stage

    def logged_rows(self, lo, hi):
        if not log or log[-1] != f"write {lo}":  # x || y then scalars: one write a batch
            log.append(f"write {lo}")
        return rows(self, lo, hi)

    def logged_stage(name, *args, **kw):
        log.append(f"stage {name}")
        return call_stage(name, *args, **kw)

    monkeypatch.setattr(gpu_engine._Staged, "rows", logged_rows)
    monkeypatch.setattr(gpu_engine, "_call_stage", logged_stage)
    return log


@pytest.mark.parametrize("path", ["wire", "plan"])
def test_each_batch_is_queued_before_the_next_is_written(clean_trace, path, monkeypatch):
    inputs = input_sets(4, path)
    sets = inputs.sets[:1]
    if path == "plan":
        plan = MSMPlan(sets[0].points, config=CFG, device="cpu")
    log = event_log(monkeypatch)
    got = run(path, sets) if path == "wire" else plan_msm(plan, sets[0].scalars)
    assert got == reference(inputs, sets)
    kind = {"wire": "wire_batch", "plan": "fixed_batch"}[path]
    batch = f"stage {kind}_w8_c2x2_s1"
    assert log == [e for b in range(4) for e in (f"write {b * BATCH}", batch)] + ["stage finish_w8_s1"]


@pytest.mark.parametrize("where", ["first_batch", "last_batch"])
@pytest.mark.parametrize("path", ["wire", "plan"])
def test_a_scalar_signed_digits_cannot_take_requeues_the_job(clean_trace, path, where, monkeypatch):
    """The batches before the failing one are queued on signed digits; the
    failing one is not; the rest are written, then the whole job is queued
    again on unsigned digits, and the result is exact."""
    inputs = input_sets(4, path)
    s = inputs.sets[0]
    row = 0 if where == "first_batch" else n_points(4) - 1
    s.scalars[row] = TOO_BIG
    if path == "plan":
        plan = MSMPlan(s.points, config=CFG, device="cpu")
    log = event_log(monkeypatch)
    trace.reset()
    got = run(path, [s]) if path == "wire" else plan_msm(plan, s.scalars)
    assert got == reference(inputs, [s])
    speculative = 0 if where == "first_batch" else 3
    assert trace.counts() == counted(path, 4, 1, speculative, 1, speculative + 4)
    kind = {"wire": "wire_batch", "plan": "fixed_batch"}[path]
    writes = [f"write {b * BATCH}" for b in range(4)]
    assert log == ([e for b in range(speculative) for e in (writes[b], f"stage {kind}_w8_c2x2_s1")]
                   + writes[speculative:] + [f"stage {kind}_w8_c2x2_s0"] * 4 + ["stage finish_w8_s0"])
    labels = [label for label, _ in trace.records() if label not in trace.COUNTERS]
    assert labels.count("queue stages") == speculative + 1


@pytest.mark.parametrize("path", ["wire", "plan"])
def test_only_the_failing_job_of_a_batch_is_requeued(clean_trace, path):
    inputs = input_sets(2, path)
    sets = inputs.sets[:2]
    sets[1].scalars[BATCH + 1] = TOO_BIG  # the second job's second batch
    assert run(path, sets) == reference(inputs, sets)
    # job 0 streams its first batch; job 1 its first, on signed digits, then
    # both of its batches again
    assert trace.counts() == counted(path, 2, 2, 2, 1, 2 + 1 + 2)


@pytest.mark.parametrize("path", ["wire", "plan"])
def test_unsigned_digits_test_nothing_and_requeue_nothing(clean_trace, path, monkeypatch):
    inputs = input_sets(4, path)
    s = inputs.sets[0]
    s.scalars[0] = TOO_BIG  # unsigned digits take any 256-bit scalar
    tests = []
    signed_rows = gpu_engine._signed_rows
    monkeypatch.setattr(gpu_engine, "_signed_rows", lambda rows: tests.append(len(rows)) or signed_rows(rows))
    assert run(path, [s], UNSIGNED) == reference(inputs, [s])
    assert tests == []
    assert trace.counts() == counted(path, 4, 1, 3, 0, 4)
    stages = [label for label, _ in trace.records() if label.startswith("stage ") and ":" in label]
    assert all("_s0:" in label for label in stages) and len(stages) == 5
    # with signed digits each batch is tested once, on its own source rows,
    # and the test stops at the first that fails
    trace.reset()
    assert run(path, [s], CFG) == reference(inputs, [s])
    assert tests == [BATCH]
    tests.clear()
    assert run(path, inputs.sets[1:], CFG) == reference(inputs, inputs.sets[1:])
    assert tests == [BATCH] * 3 + [2]  # the last batch's 2 rows and 2 of padding


@pytest.mark.parametrize("path", ["wire", "plan"])
def test_a_length_mismatch_raises_before_any_write_or_stage(clean_trace, path, monkeypatch):
    """The API checks the row counts (the engines take its rows as they
    are): a short scalar array raises there, before anything is staged."""
    inputs = input_sets(2, path)
    s = inputs.sets[0]
    plan = MSMPlan(s.points, config=CFG, device="cpu") if path == "plan" else None
    log = event_log(monkeypatch)
    trace.reset()
    with pytest.raises(ValueError, match="mismatch|plan holds"):
        if path == "wire":
            compute_msm(s.points, s.scalars[:-1], config=CFG, device="cpu")
        else:
            plan.msm(s.scalars[:-1])
    assert log == [] and trace.counts() == dict.fromkeys(trace.COUNTERS, 0)


def test_rows_written_slice_by_slice_equal_one_write():
    """A job's host buffer written batch by batch, in any order, holds what
    one write of every row gives: the rows, then the padding."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 2**32, size=(10, 32), dtype=np.uint32)
    cpu = gpu_engine.resolve_device("cpu")
    whole = gpu_engine._stage_xy(rows, 16, cpu).rows(0, 16)
    staged = gpu_engine._stage_xy(rows, 16, cpu)
    for lo in (12, 4, 8, 0):
        staged.rows(lo, lo + 4)
    assert np.array_equal(staged.tensor.numpy(), whole.numpy())
    want = np.zeros((16, 16), np.uint32)
    want[:10] = rows[:, :16]
    want[10:, 15] = 1
    np.testing.assert_array_equal(whole.numpy().view(np.uint32), want)
