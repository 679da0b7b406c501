"""combine_windows_ms: the program's span "combine windows" (a host clock
around the window sums turned into points, combined and made affine in
Python integers), in ms per traced MSM. Layer: engines.gpu_engine, host
combine."""

SPAN = "combine windows"


def read(tr):
    times = tr.phases.get(SPAN)
    if not times:
        return None
    return sum(times) / tr.msms
