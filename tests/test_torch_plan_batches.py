"""`MSMPlan` across many batches on the CPU, against the benchmark's plain
PyTorch reference (`msm_bench/reference/`, which shares no code with the
port): the ZPrize 2022 fixed-base shape, a plan over fixed bases and an
`msm_batch` of four jobs, with the chunking forced small so that one plan
spans 41 batches, the last one partial, as a 2^26-point plan spans 256.
The program's counters of staged bytes and queued batch stages are held
to their reckoned values.
"""
import pytest

from msm_bench.reference import expected, inputs as reference_inputs
from webgpu_msm_tpu_torch import MSMConfig, MSMPlan
from webgpu_msm_tpu_torch.utils import trace

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

SEED = 2**40 + 22
BATCH = 4  # points a batch: n_chunks 2 x chunk_len 2
N = 40 * BATCH + 2  # 41 batches, the last holding 2 points and 2 of padding
PAD_TO = 41 * BATCH
JOBS = 4  # an msm_batch of four scalar vectors, as the prize's batch
CFG = MSMConfig(window_size=8, n_chunks=2, chunk_len=2)


@pytest.fixture(scope="module")
def fixed_base_inputs():
    """JOBS input sets over one fixed point array, and each set's exact
    result from the reference."""
    inputs = reference_inputs.make_inputs(SEED, [N], JOBS, True, 253, "cpu")
    return inputs.sets, [expected.expected_result(inputs.k0, s, "cpu") for s in inputs.sets]


def test_plan_over_many_batches_matches_the_reference(fixed_base_inputs):
    sets, want = fixed_base_inputs
    assert all(s.points is sets[0].points for s in sets)
    trace.reset()
    plan = MSMPlan(sets[0].points, config=CFG, device="cpu")
    assert plan._plan.pad_to == PAD_TO and len(plan._plan._rows) == 41
    # the build stages the bases' x || y rows (64 bytes a point) and queues no batch stage
    assert trace.counts() == {trace.STAGED_BYTES: PAD_TO * 64, trace.BATCH_STAGES: 0,
                              trace.BATCHES_STREAMED: 0, trace.SIGNED_REQUEUES: 0,
                              trace.PARALLEL_BATCHES: 0}
    assert [label for label, _ in trace.records()][-2:] == ["build plan", trace.STAGED_BYTES]

    trace.reset()
    got = plan.msm_batch([s.scalars for s in sets])
    assert [(r.x, r.y) for r in got] == want
    # each job stages its scalar rows (32 bytes a point) and queues one stage
    # a batch, each as soon as the batch is written: 40 before the job's last
    assert trace.counts() == {trace.STAGED_BYTES: JOBS * PAD_TO * 32, trace.BATCH_STAGES: JOBS * 41,
                              trace.BATCHES_STREAMED: JOBS * 40, trace.SIGNED_REQUEUES: 0,
                              trace.PARALLEL_BATCHES: 0}
    labels = [label for label, _ in trace.records()]
    assert labels.count("stage fixed_batch_w8_c2x2_s1: eager") == JOBS * 41
    assert labels[-3:] == [trace.STAGED_BYTES, trace.BATCH_STAGES, trace.BATCHES_STREAMED]

    trace.reset()
    assert trace.counts() == dict.fromkeys(trace.COUNTERS, 0) and trace.records() == []
