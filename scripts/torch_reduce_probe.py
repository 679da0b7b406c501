#!/usr/bin/env python3
"""What bounds the end of the bucket reduction on the card: a probe build
beside the kernel library, timed with CUDA events and clock64() stamps.

    python3 scripts/torch_reduce_probe.py   (one NVIDIA GPU, nvcc)

1. Latency of dependent point operations: one thread a lane runs a chain
   of unified adds (or dbl-2008-hwcd doublings) on operands in registers,
   with 1, 4 and 8 warps an SM (one block an SM): microseconds an
   operation from the CUDA-event time of the launch, cycles from clock64().
2. The same add chain where each step first loads its operand from
   [4][16][W] digit planes, the layout of T and U, at a point stride of
   q = 1, 2, 9 or 65 between a thread's steps (the old reduce_finish's
   threads read groups t * q + j): the loads' share of a step.
3. A copy of the earlier tree reduce_finish kernel (`tree_sums`, two lanes
   of P = 128 threads a block, one block a window) with clock64() stamps
   at its phase boundaries, at the wire (K 20, G 129, 5 doublings), the
   resident (K 16, G 1 025, 5) and the Gs 4 (K 16, G 8 200, 2) shapes:
   the cycles of thread 0 in each phase, the mean over windows.

Compiles its CUDA source (below) with the package's nvcc flags and the
package's `csrc/field.cuh`. Prints one JSON line with the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

PROBE = r"""
#include <cuda_runtime.h>
#include "field.cuh"
using namespace msm;

// 1. A chain of `n` dependent point operations a thread on registers.
__global__ void op_chain(const int32_t* in, int32_t* out, long long* cycles, int n, int dbl) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x, W = gridDim.x * blockDim.x;
  Pt acc, x;
  load_pt(acc, in, (size_t)W, w);
  load_pt(x, in + 64 * (size_t)W, (size_t)W, w);
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; i++) {
    if (dbl) point_double(acc, acc);
    else unified_add(acc, acc, x);
  }
  const long long t1 = clock64();
  store_pt(out, (size_t)W, w, acc);
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

// 2. The same add chain, each step's operand loaded first from digit
// planes of `width` points at point stride q.
__global__ void load_chain(const int32_t* planes, int32_t* out, long long* cycles, int n, int q,
                           int width) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x, W = gridDim.x * blockDim.x;
  Pt acc, x;
  set_identity(acc);
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; i++) {
    load_pt(x, planes, (size_t)width, ((size_t)w * q + i) % width);
    unified_add(acc, acc, x);
  }
  const long long t1 = clock64();
  store_pt(out, (size_t)W, w, acc);
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

// 3. The earlier tree reduce_finish, with stamps.
__device__ __forceinline__ void sm_put(u32* sm, int n, int slot, const Pt& p) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    sm[i * n + slot] = p.x[i];
    sm[(8 + i) * n + slot] = p.y[i];
    sm[(16 + i) * n + slot] = p.t[i];
    sm[(24 + i) * n + slot] = p.z[i];
  }
}

__device__ __forceinline__ void sm_get(Pt& p, const u32* sm, int n, int slot) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    p.x[i] = sm[i * n + slot];
    p.y[i] = sm[(8 + i) * n + slot];
    p.t[i] = sm[(16 + i) * n + slot];
    p.z[i] = sm[(24 + i) * n + slot];
  }
}

constexpr int kStamps = 7;

__global__ void __launch_bounds__(256)
old_reduce_finish_stamped(const int32_t* __restrict__ T, const int32_t* __restrict__ U,
                          int32_t* __restrict__ out_mont, long long* stamps, int G, int K, int P,
                          int doublings) {
  extern __shared__ u32 sm[];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int32_t* src = (tid & 1) ? U : T;
  const size_t stride = (size_t)K * G;
  long long st[kStamps];
  st[0] = clock64();
  auto elem = [&](Pt& p, int g) {
    if (g < G) load_pt(p, src, stride, (size_t)k * G + g);
    else set_identity(p);
  };
  const int n = blockDim.x, LB = n / P, t = tid / LB;
  const int q = (G + P - 1) / P;
  Pt x, Tt, Uu;
  elem(Tt, t * q + q - 1);
#pragma unroll 1
  for (int j = q - 2; j >= 0; j--) {
    elem(x, t * q + j);
    unified_add(Tt, x, Tt);
  }
  st[1] = clock64();
#pragma unroll 1
  for (int d = 1; d < P; d <<= 1) {
    sm_put(sm, n, tid, Tt);
    __syncthreads();
    if (t + d < P) sm_get(x, sm, n, tid + d * LB);
    __syncthreads();
    if (t + d < P) unified_add(Tt, Tt, x);
  }
  st[2] = clock64();
  if (q == 1) {
    Uu = Tt;
    if (t == 0) set_identity(Uu);
  } else {
    Pt run;
    sm_put(sm, n, tid, Tt);
    __syncthreads();
    if (t + 1 < P) sm_get(run, sm, n, tid + LB);
    else set_identity(run);
    __syncthreads();
#pragma unroll 1
    for (int j = q - 1; j >= 0; j--) {
      elem(x, t * q + j);
      unified_add(run, run, x);
      if (j == q - 1) Uu = run;
      else if (t * q + j > 0) unified_add(Uu, Uu, run);
    }
  }
  st[3] = clock64();
#pragma unroll 1
  for (int h = P >> 1; h >= 1; h >>= 1) {
    sm_put(sm, n, tid, Uu);
    __syncthreads();
    if (t < h) sm_get(x, sm, n, tid + h * LB);
    __syncthreads();
    if (t < h) unified_add(Uu, Uu, x);
  }
  st[4] = clock64();
  sm_put(sm, blockDim.x, tid, Tt);
  __syncthreads();
  if (tid != 0) return;
  sm_get(Tt, sm, blockDim.x, 1);
#pragma unroll 1
  for (int i = 0; i < doublings; i++) point_double(Uu, Uu);
  st[5] = clock64();
  unified_add(Uu, Uu, Tt);
  const u32 one[8] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  mont_mul(Uu.x, Uu.x, one);
  mont_mul(Uu.y, Uu.y, one);
  mont_mul(Uu.t, Uu.t, one);
  mont_mul(Uu.z, Uu.z, one);
  store_pt(out_mont, (size_t)K, k, Uu);
  st[6] = clock64();
  for (int i = 0; i < kStamps; i++) stamps[(size_t)k * kStamps + i] = st[i];
}

extern "C" int launch_op_chain(const void* in, void* out, void* cycles, int blocks, int threads,
                               int n, int dbl) {
  op_chain<<<blocks, threads>>>((const int32_t*)in, (int32_t*)out, (long long*)cycles, n, dbl);
  return (int)cudaGetLastError();
}

extern "C" int launch_load_chain(const void* planes, void* out, void* cycles, int blocks,
                                 int threads, int n, int q, int width) {
  load_chain<<<blocks, threads>>>((const int32_t*)planes, (int32_t*)out, (long long*)cycles, n, q,
                                  width);
  return (int)cudaGetLastError();
}

extern "C" int launch_old_reduce_finish_stamped(const void* T, const void* U, void* out,
                                                void* stamps, int G, int K, int P, int doublings) {
  old_reduce_finish_stamped<<<K, 2 * P, 256 * P>>>((const int32_t*)T, (const int32_t*)U,
                                                    (int32_t*)out, (long long*)stamps, G, K, P,
                                                    doublings);
  return (int)cudaGetLastError();
}
"""

SHAPES = {"wire": (20, 129, 5), "resident": (16, 1025, 5), "gs4": (16, 8200, 2)}
PHASES = ("chunk sums", "suffix scan", "U walk", "fold", "doublings", "add and from_mont")


def planes(gen, lead, width, dev):
    d = torch.randint(0, 1 << 16, lead + (16, width), generator=gen, dtype=torch.int32)
    d[..., 15, :] = torch.randint(0, 0x12AB, lead + (width,), generator=gen, dtype=torch.int32)
    return d.to(dev)


def event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    from webgpu_msm_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "reduce_probe.cu"
    src.write_text(PROBE)
    nvcc = shutil.which("nvcc") or str(build.NVCC_DEFAULT)
    so = src.with_suffix(".so")
    comp = subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared", "-o", str(so), str(src)],
                          capture_output=True, text=True, timeout=600)
    if comp.returncode:
        raise RuntimeError(comp.stdout + comp.stderr)
    ptxas = [ln.strip() for ln in (comp.stdout + comp.stderr).splitlines() if "registers" in ln or "spill" in ln]
    lib = ctypes.CDLL(str(so))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.launch_op_chain.argtypes = [P_, P_, P_, I_, I_, I_, I_]
    lib.launch_load_chain.argtypes = [P_, P_, P_, I_, I_, I_, I_, I_]
    lib.launch_old_reduce_finish_stamped.argtypes = [P_, P_, P_, P_, I_, I_, I_, I_]
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(16)

    def ok(rc, what):
        if rc:
            raise RuntimeError(f"{what}: launch failed ({rc})")

    out = {"card": smi, "ptxas": ptxas}
    n_ops, sms = 64, torch.cuda.get_device_properties(0).multi_processor_count
    chains = {}
    for warps in (1, 4, 8):
        W = sms * 32 * warps
        src_pts = planes(gen, (8,), W, dev)
        res = torch.empty((4, 16, W), dtype=torch.int32, device=dev)
        cyc = torch.zeros(sms, dtype=torch.int64, device=dev)
        for name, dbl in (("add", 0), ("double", 1)):
            run = lambda: ok(lib.launch_op_chain(src_pts.data_ptr(), res.data_ptr(), cyc.data_ptr(), sms,
                                                 32 * warps, n_ops, dbl), "op_chain")
            run()
            ms = min(event_ms(run) for _ in range(3))
            chains[f"{name} {warps} warps/SM"] = {"us_per_op": ms * 1e3 / n_ops,
                                                  "cycles_per_op": float(cyc.double().mean()) / n_ops}
    out["chains"] = chains
    loads = {}
    width = 20 * 129 * 65
    pl = planes(gen, (4,), width, dev)
    for warps in (1, 8):
        W = sms * 32 * warps
        res = torch.empty((4, 16, W), dtype=torch.int32, device=dev)
        cyc = torch.zeros(sms, dtype=torch.int64, device=dev)
        for q in (1, 2, 9, 65):
            run = lambda: ok(lib.launch_load_chain(pl.data_ptr(), res.data_ptr(), cyc.data_ptr(), sms, 32 * warps,
                                                   n_ops, q, width), "load_chain")
            run()
            ms = min(event_ms(run) for _ in range(3))
            loads[f"q {q}, {warps} warps/SM"] = {"us_per_step": ms * 1e3 / n_ops,
                                                 "cycles_per_step": float(cyc.double().mean()) / n_ops}
    out["load_chains"] = loads
    old = {}
    for shape, (K, G, d) in SHAPES.items():
        T, U = planes(gen, (4,), K * G, dev), planes(gen, (4,), K * G, dev)
        res = torch.empty((4, 16, K), dtype=torch.int32, device=dev)
        st = torch.zeros((K, len(PHASES) + 1), dtype=torch.int64, device=dev)
        run = lambda: ok(lib.launch_old_reduce_finish_stamped(T.data_ptr(), U.data_ptr(), res.data_ptr(),
                                                              st.data_ptr(), G, K, 128, d), "old reduce_finish")
        run()
        ms = sorted(event_ms(run) for _ in range(5))[2]
        deltas = (st[:, 1:] - st[:, :-1]).double().mean(0).tolist()
        total = sum(deltas)
        old[shape] = {"ms": ms, "cycles": total, "phases": dict(zip(PHASES, deltas)),
                      "us_per_cycle_at_event_time": ms * 1e3 / total}
    out["old_reduce_finish"] = old
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
