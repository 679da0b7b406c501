"""The multi-GPU layer: the JAX package's `parallel/` over `torch.distributed`."""
from .msm_sharded import (  # noqa: F401
    AXIS,
    Mesh,
    ShardedFixedBasePlan,
    default_mesh,
    msm_window_sums_sharded,
    sharded_stages,
    tree_add_points,
)
