"""batch_stage_ms: device ms per MSM of every kernel but the finish
stage's (the conversion, the sort and the plain ops, the gathering scan,
lane_scan, assemble_buckets), from the profiler's kernel records; a
hand-written kernel counts its mean record times the program's launches.
Layer: ops.pippenger, batch stage."""
from msm_bench import trace_reader, yardstick


def read(tr):
    names = {r.name for r in tr.device if not r.name.startswith(("Memcpy", "Memset"))}
    names -= set(yardstick.FINISH_KERNELS)
    if not names:
        return None
    return sum(trace_reader.kernel_us(tr, k) for k in names) / 1e3 / tr.msms
