"""host_calls_per_msm: CUDA runtime calls that launch a kernel or a graph
or queue a copy or a memset, per MSM, from the profiler's host records.
A count: it repeats exactly. Layer: utils.cache, stage graphs."""


def read(tr):
    if not tr.device:
        return None
    return tr.runtime_calls / tr.msms
