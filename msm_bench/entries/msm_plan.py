"""Fixed bases, as in the ZPrize 2022 MSM harness: the plan is built over
the bases in set-up (`MSMPlan`), and a call is `plan.msm(scalars)` for
one job or `plan.msm_batch(jobs)` for several."""
import webgpu_msm_tpu_torch as msm


def setup(inputs, device):
    return msm.MSMPlan(inputs.sets[0].points, device=device)


def call(plan, sets):
    if len(sets) == 1:
        r = plan.msm(sets[0].scalars)
        return [(r.x, r.y)]
    return [(r.x, r.y) for r in plan.msm_batch([s.scalars for s in sets])]
