"""The control: the plain reference put in the program's place, computing
each MSM at a lower precision (its scalars without their low 16 bits,
`expected.control_result`). The comparison has to find it not correct;
the benchmark's own runs never call it (`msm_bench/control.py` and the
tests do)."""
from . import expected


def setup(inputs, device):
    return inputs.k0, device


def call(state, sets):
    k0, device = state
    return [expected.control_result(k0, s, device) for s in sets]
