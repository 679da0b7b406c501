"""fetch_wait_ms: the program's span "fetch" (a host clock around a job's
window sums brought to the host: the wait for the device, then the copy),
in ms per traced MSM. Layer: engines.gpu_engine, fetch."""

SPAN = "fetch"


def read(tr):
    times = tr.phases.get(SPAN)
    if not times:
        return None
    return sum(times) / tr.msms
