"""plan_inputs_ms: the program's span "stage scalars (plan)" (a host clock
around a plan job's signed-digit test and the write of its scalar rows
into pinned memory), in ms per traced MSM. Layer: engines.gpu_engine,
plan staging."""

SPAN = "stage scalars (plan)"


def read(tr):
    times = tr.phases.get(SPAN)
    if not times:
        return None
    return sum(times) / tr.msms
