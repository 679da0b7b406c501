"""device_idle_share: the share of the traced stretch (the first call's
start to the last one's end) in which the device ran no kernel, copy or
memset, in %. Layer: device."""
from msm_bench import trace_reader


def read(tr):
    if not tr.device:
        return None
    lo, hi = tr.window
    return 100 * (1 - trace_reader.busy_us(tr) / (hi - lo))
