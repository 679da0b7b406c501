"""The readers of the program's spans (`metrics/<name>.py`, source
`program_span`) on a synthetic trace: per MSM, so a call of four jobs
counts four; None where the span is absent, as on a program that has
none; the stage spans' outcomes other than `replay` counted."""
import pytest

from msm_bench import harness
from msm_bench.tests.test_msmbench_metrics import METRICS, _trace

SPANS = {  # reader -> the span it reads
    "check_inputs_ms": "check inputs (wire)",
    "plan_inputs_ms": "stage scalars (plan)",
    "queue_stages_ms": "queue stages",
    "fetch_wait_ms": "fetch",
    "combine_windows_ms": "combine windows",
}
STAGES = {
    "stage fixed_batch_w13_c2048x128_s1: replay": [0.2] * 16,
    "stage finish_w13_s1: replay": [0.1] * 4,
}


def metric(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_span_metric_{name}")


def four_job_call(phases):
    """One traced call of four jobs (a plan's msm_batch)."""
    return _trace(calls=[(0.0, 200.0, 4)], phases=phases)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_readers_give_ms_per_msm(name):
    # two jobs' spans of 3 and 5 ms and two of 1 ms, in one call of four jobs
    tr = four_job_call({SPANS[name]: [3.0, 5.0, 1.0, 1.0], "slice/pad inputs (wire)": [99.0], **STAGES})
    assert metric(name).read(tr) == pytest.approx(10.0 / 4)


@pytest.mark.parametrize("name", sorted(SPANS) + ["stage_misses_per_msm"])
def test_span_readers_find_nothing_without_their_span(name):
    """A program without these spans, which records only the wire path's
    two phases, gives each reader nothing: None."""
    tr = four_job_call({"slice/pad inputs (wire)": [4.0], "device msm (wire)": [2.0]})
    assert metric(name).read(tr) is None


def test_stage_misses_count_every_outcome_but_replay():
    read = metric("stage_misses_per_msm").read
    assert read(four_job_call(dict(STAGES))) == 0  # a warm call: every stage replays
    phases = {**STAGES, "stage fixed_batch_w13_c2048x128_s0: capture": [40.0],
              "stage finish_w13_s0: eager": [1.0, 1.0], "stage scalars (plan)": [3.0] * 4,
              "queue stages": [1.0] * 4}
    assert read(four_job_call(phases)) == pytest.approx(3 / 4)  # not the plan's staging span
    two_calls = _trace(phases=phases)  # two calls of two MSMs each
    assert read(two_calls) == pytest.approx(3 / 4)
