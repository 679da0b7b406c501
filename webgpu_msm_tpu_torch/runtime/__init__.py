"""The port's native host libraries, built with g++ at first use and
loaded with ctypes: the CPU MSM engine (`csrc/msm_cpu.cpp`) and the GPU
engine's staging row copier (`csrc/row_copy.cpp`, `rows.py`)."""
from .build import NativeBuildError, load  # noqa: F401
