"""tpu-msm's PyTorch/CUDA port: the wire-format MSM on an NVIDIA H100.

A second package beside the JAX package `webgpu_msm_tpu`, which stays the
reference. It imports torch and numpy only. The point kernels are written
by hand in CUDA C++ for sm_90a (`ops/kernels/csrc`), built with nvcc at
first use; on the CPU each kernel's plain PyTorch version runs instead.

    compute_msm(points, scalars, device=None) -> AffinePoint(x, y)
"""

__version__ = "0.1.0"

from .api import AffinePoint, compute_msm  # noqa: F401
from .config import MSMConfig  # noqa: F401
