"""finish_stage_ms: device ms per MSM of grouped_running_sum,
reduce_finish and (with device_affine) finish_affine_divsteps, their mean
record times the program's launches. Layer: ops.pippenger, finish stage."""
from msm_bench import trace_reader, yardstick


def read(tr):
    times = [trace_reader.kernel_us(tr, k) for k in yardstick.FINISH_KERNELS]
    times = [t for t in times if t is not None]
    if not times:
        return None
    return sum(times) / 1e3 / tr.msms
