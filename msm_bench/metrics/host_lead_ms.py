"""host_lead_ms: mean over the traced calls of the time from the call's
start (the benchmark's span) to the first device copy, memset or kernel
after it. Layer: api and engines.gpu_engine, host dispatch."""
import bisect


def read(tr):
    starts = [r.start for r in tr.device]
    leads = []
    for start, end, _ in tr.calls:
        i = bisect.bisect_left(starts, start)
        if i < len(starts) and starts[i] < end:
            leads.append(starts[i] - start)
    if not leads:
        return None
    return sum(leads) / len(leads) / 1e3
