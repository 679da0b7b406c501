"""tpu-msm's PyTorch/CUDA port: the MSM on an NVIDIA H100.

A second package beside the JAX package `webgpu_msm_tpu`, which stays the
reference. It imports torch and numpy only. The point kernels are written
by hand in CUDA C++ for sm_90a (`ops/kernels/csrc`), built with nvcc at
first use; on the CPU each kernel's plain PyTorch version runs instead.

    compute_msm(points, scalars, device=None, engine=None) -> AffinePoint(x, y)
    compute_msm_batch(points_list, scalars_list, device=None) -> [AffinePoint]
    MSMPlan(points, device=None).msm(scalars) / .msm_batch(scalars_list)

Engines: "gpu" (the default), "hybrid", "naive", "baseline", "oracle" and
"cpu", as in the JAX package (`api.py`); the native CPU engine is built
with g++ at first use (`runtime/`).
"""

__version__ = "0.1.0"

from .api import AffinePoint, MSMPlan, compute_msm, compute_msm_batch  # noqa: F401
from .config import MSMConfig  # noqa: F401
