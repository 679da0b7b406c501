"""check_inputs_ms: the program's span "check inputs (wire)" (a host
clock around the validation of a call's inputs: the point rows, the z
check, the scalar rows), in ms per traced MSM. Layer: api, input checks."""

SPAN = "check inputs (wire)"


def read(tr):
    times = tr.phases.get(SPAN)
    if not times:
        return None
    return sum(times) / tr.msms
