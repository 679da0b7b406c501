"""stage_gbps: the bytes the program counts as written into host memory
for the device (its counter "bytes staged": the wire path's x || y and
scalar rows, a plan job's scalar rows, pinned on a GPU) over the seconds
of the spans that write them, "slice/pad inputs (wire)" and "stage
scalars (plan)" (each with the job's signed-digit test), in the traced
stretch; GB/s, 10^9 bytes a second. Layer: engines.gpu_engine, pinned
staging."""

COUNTER = "bytes staged"
SPANS = ("slice/pad inputs (wire)", "stage scalars (plan)")


def read(tr):
    staged = sum(tr.phases.get(COUNTER, ()))
    ms = sum(sum(tr.phases.get(span, ())) for span in SPANS)
    if not staged or not ms:
        return None
    return staged / ms / 1e6
