"""One call of the ZPrize 2023 web MSM: `compute_msm` on a [n, 32] u32
point array and a [n, 8] u32 scalar array, one MSM a call."""
import webgpu_msm_tpu_torch as msm


def setup(inputs, device):
    return device


def call(device, sets):
    if len(sets) != 1:
        raise ValueError("compute_msm takes one MSM a call")
    r = msm.compute_msm(sets[0].points, sets[0].scalars, device=device)
    return [(r.x, r.y)]
