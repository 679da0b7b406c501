"""reduce_finish_roofline: the least time of the reduce_finish kernel's work
over its device time, in %. The least time is the sums over each window's
groups, the doublings, one add and four from_mont
(yardstick.reduce_finish_products), as chip_smoke.py's bound() counts it, at
the window size and batches that the program's
MSMConfig().resolved_wire_plan(n) gives, times OPS_PER_MONT_MUL 32-bit
multiplies, over the mad.lo.u32 rate this run measured. Device time: the
kernel's mean record times the program's launches. Layer: ops.kernels."""
from msm_bench import trace_reader, yardstick


def read(tr):
    us = trace_reader.kernel_us(tr, "reduce_finish_kernel")
    if us is None or not tr.mad_rate or not tr.shape:
        return None
    least = yardstick.least_ms(yardstick.reduce_finish_products(tr.shape), tr.mad_rate) * tr.msms
    return 100 * least / (us / 1e3)
