"""queue_stages_ms: the program's span "queue stages" (a host clock around
a job's identity carry and its stage calls, queued on the stream and not
waited for), in ms per traced MSM. Layer: utils.cache, stage graphs (host
side)."""

SPAN = "queue stages"


def read(tr):
    times = tr.phases.get(SPAN)
    if not times:
        return None
    return sum(times) / tr.msms
