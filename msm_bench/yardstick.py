"""Frozen arithmetic of the benchmark: operation counts, the pipeline's
shapes, and the measured multiply rate that the roofline shares divide by.

Copied here so that a change to the program cannot move the yardstick;
each block names where it was copied from.
"""
from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

# Copied from chip_smoke.py (OPS_PER_MONT_MUL, OPS_PER_MONT_REDUCE): 32-bit
# multiplies in one 8-limb CIOS Montgomery product (a*b: 64, m*p: 64, m:
# 8), two operations (low and high word) each; a from_mont reduction has
# only the m*p and m halves.
OPS_PER_MONT_MUL = 2 * (64 + 64 + 8)
OPS_PER_MONT_REDUCE = 2 * (64 + 8)

# Kernels of the finish stage, by the symbol the profiler records.
FINISH_KERNELS = ("grouped_running_sum_kernel", "reduce_finish_kernel",
                  "finish_affine_divsteps_kernel")


def pipeline_shape(n: int, wire_plan) -> dict:
    """The shapes one MSM of n host-fed points runs at, from the program's
    public `MSMConfig().resolved_wire_plan(n)` = (w, C, L), read at run
    time. The rules below are copies of the program's at the time of
    writing: `ops/windows.py` n_windows (K = ceil(256 / w)),
    `ops/pippenger.py` n_buckets (signed digits: 2^(w-1) + 1 padded to
    a multiple of 32) and group_size (32 from 1 024 buckets, 16 from 64),
    `engines/gpu_engine.py` _padded_plan (whole batches of C * L)."""
    w, C, L = wire_plan
    K = -(-256 // w)
    B = -(-((1 << (w - 1)) + 1) // 32) * 32
    Gs = 32 if B >= 1024 else (16 if B >= 64 else 1)
    M = C * L
    return {"n": n, "w": w, "C": C, "L": L, "K": K, "B": B, "Gs": Gs, "G": B // Gs,
            "doublings": Gs.bit_length() - 1, "pad_to": -(-n // M) * M}


# The parts of chip_smoke.py's bound() for three kernels, as Montgomery
# products (each OPS_PER_MONT_MUL operations) per MSM.
def scan_products(shape: dict) -> float:
    """accumulate_scan_gather: 7 products for each point and window
    (bound(): muls = 7 * L * W, W = K * C lanes, per batch of C * L)."""
    return 7 * shape["K"] * shape["pad_to"]


def grouped_running_sum_products(shape: dict) -> float:
    """grouped_running_sum: the serial chain's 2 Gs - 1 adds of 9 products
    over W = K * G lanes (bound(): muls = 9 * (2 * Gs - 1) * W)."""
    return 9 * (2 * shape["Gs"] - 1) * shape["K"] * shape["G"]


def reduce_finish_products(shape: dict) -> float:
    """reduce_finish: per window, sum_g g * T_g (2G - 1 adds), sum_g U_g
    (G - 1), the doublings (8 products each), one add and four from_mont
    (bound(): K * (9 * (3G - 2) + 8 * doublings + 9 + 4 * REDUCE / MUL))."""
    G, d = shape["G"], shape["doublings"]
    return shape["K"] * (9 * (3 * G - 2) + 8 * d + 9 + 4 * OPS_PER_MONT_REDUCE / OPS_PER_MONT_MUL)


# Copied from chip_smoke.py (MAD_PROBE, mad_rate_per_s): eight independent
# mad.lo.u32 chains a thread on every SM, nothing but multiply issue.
MAD_PROBE = """
#include <cuda_runtime.h>
__global__ void mad_rate_probe(unsigned* out, const unsigned* in, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned c = in[0] | 1u, d = in[1];
  unsigned a[8];
#pragma unroll
  for (int j = 0; j < 8; j++) a[j] = t + j;
  for (int i = 0; i < iters; i++) {
#pragma unroll
    for (int j = 0; j < 8; j++)
      asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a[j]) : "r"(c), "r"(d));
  }
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) s ^= a[j];
  out[t] = s;
}
extern "C" int launch_mad_rate_probe(void* out, const void* in, int n_blocks, int threads,
                                     int iters, void* stream) {
  mad_rate_probe<<<n_blocks, threads, 0, (cudaStream_t)stream>>>((unsigned*)out,
                                                                 (const unsigned*)in, iters);
  return (int)cudaGetLastError();
}
"""
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def build_mad_probe(build_dir: Path) -> ctypes.CDLL:
    """The probe's library, built once per source into `build_dir` (a fixed
    directory of the checkout), so that only a checkout's first run builds."""
    tag = hashlib.sha256((MAD_PROBE + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
    so = build_dir / f"mad_rate_probe-{tag}.so"
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        src = build_dir / f"mad_rate_probe-{tag}.cu"
        src.write_text(MAD_PROBE)
        nvcc = shutil.which("nvcc") or NVCC_DEFAULT
        tmp = so.with_suffix(".tmp")
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)], check=True,
                       capture_output=True, text=True, timeout=300)
        tmp.replace(so)
    lib = ctypes.CDLL(str(so))
    lib.launch_mad_rate_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.launch_mad_rate_probe.restype = ctypes.c_int
    return lib


def mad_rate_per_s(lib: ctypes.CDLL, reps: int = 5) -> float:
    """32-bit multiply-adds a second that the card issues: `reps` launches
    after a warm one, timed together by CUDA events (chip_smoke.py's
    cuda_ms)."""
    import torch

    n_blocks, threads, iters = 132 * 16, 256, 4096
    out = torch.zeros(n_blocks * threads, dtype=torch.int32, device="cuda")
    words = torch.tensor([12345, 678], dtype=torch.int32, device="cuda")

    def launch():
        rc = lib.launch_mad_rate_probe(out.data_ptr(), words.data_ptr(), n_blocks, threads, iters,
                                       torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mad_rate_probe: launch failed ({rc})")

    launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return n_blocks * threads * iters * 8 / (start.elapsed_time(end) / reps * 1e-3)


def least_ms(products: float, ops_per_s: float) -> float:
    return products * OPS_PER_MONT_MUL / ops_per_s * 1e3
