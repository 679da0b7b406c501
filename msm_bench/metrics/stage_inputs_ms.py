"""stage_inputs_ms: the program's phase "slice/pad inputs (wire)" (a host
clock around writing the x || y and scalar rows into pinned memory), in
ms per traced call. Layer: engines.gpu_engine, wire staging."""

PHASE = "slice/pad inputs (wire)"


def read(tr):
    times = tr.phases.get(PHASE)
    if not times:
        return None
    return sum(times) / len(tr.calls)
