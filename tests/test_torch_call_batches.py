"""`compute_msm` across many batches on the CPU, against the benchmark's
plain PyTorch reference (`msm_bench/reference/`): wire rows, and lists
that the API marshals to wire rows, with the chunking forced small, so that one call spans 41
batches, the last one partial. The program's counters of staged bytes and
queued batch stages are held to their reckoned values.
"""
import pytest

from msm_bench.reference import expected, inputs as reference_inputs
from webgpu_msm_tpu_torch import MSMConfig, compute_msm
from webgpu_msm_tpu_torch.utils import convert, trace

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

SEED = 2**41 + 3
BATCH = 4  # points a batch: n_chunks 2 x chunk_len 2
N = 40 * BATCH + 2  # 41 batches, the last holding 2 points and 2 of padding
PAD_TO = 41 * BATCH
CFG = MSMConfig(window_size=8, n_chunks=2, chunk_len=2)


def as_lists(s):
    """A wire input set as lists: (x, y, t, z) tuples and int scalars."""
    coords = [convert.u32_be_to_bigints(s.points[:, 8 * c : 8 * c + 8]) for c in range(4)]
    return list(zip(*coords)), convert.u32_be_to_bigints(s.scalars)


# both stage x || y and scalar rows, 96 bytes a point, the lists once the
# API has marshalled them to wire rows
PATHS = {"wire": (lambda s: (s.points, s.scalars), PAD_TO * 96),
         "lists": (as_lists, PAD_TO * 96)}


@pytest.fixture(scope="module")
def input_set():
    inputs = reference_inputs.make_inputs(SEED, [N], 1, False, 253, "cpu")
    return inputs.sets[0], expected.expected_result(inputs.k0, inputs.sets[0], "cpu")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_call_over_many_batches_matches_the_reference(input_set, path):
    s, want = input_set
    args, staged = PATHS[path]
    points, scalars = args(s)
    trace.reset()
    r = compute_msm(points, scalars, config=CFG, device="cpu")
    assert (r.x, r.y) == want
    # each batch is queued as it is written: 40 before the last
    # batches of 4 rows, below the copier's parallel bound: none shared with its pool
    assert trace.counts() == {trace.STAGED_BYTES: staged, trace.BATCH_STAGES: 41,
                              trace.BATCHES_STREAMED: 40, trace.SIGNED_REQUEUES: 0,
                              trace.PARALLEL_BATCHES: 0}
    trace.reset()
    assert trace.counts() == dict.fromkeys(trace.COUNTERS, 0) and trace.records() == []
