"""batch_replay_ms: the batch stage's device time, as `batch_stage_ms`
counts it (every kernel but the finish stage's), over the batch-stage
calls the program counts (its counter "batch stages queued": one a batch
of a job, a graph replay on the card), in ms a batch stage. Layer:
ops.pippenger, batch stage."""
from msm_bench.metrics import batch_stage_ms

COUNTER = "batch stages queued"


def read(tr):
    batches = sum(tr.phases.get(COUNTER, ()))
    per_msm = batch_stage_ms.read(tr)
    if not batches or per_msm is None:
        return None
    return per_msm * tr.msms / batches
