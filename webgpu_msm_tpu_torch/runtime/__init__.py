"""The native CPU MSM library (`csrc/msm_cpu.cpp`), built with g++ at
first use and loaded with ctypes."""
from .build import NativeBuildError, load  # noqa: F401
