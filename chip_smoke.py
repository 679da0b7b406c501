#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the device: name, count, and nvidia-smi's name and power limit.
2. Builds the CUDA kernels from `webgpu_msm_tpu_torch/ops/kernels/csrc`
   with nvcc and prints each kernel's ptxas registers, spills and shared
   memory; builds the native CPU engine (`runtime/csrc/msm_cpu.cpp`) with
   g++ and OpenMP at the same time (without them the run fails).
3. Times independent `mad.lo.u32` chains (a probe kernel in this file): the
   card's 32-bit integer multiply rate, which the operations bound of every
   kernel uses. Runs each of the fourteen kernels and its plain PyTorch version
   on the card on seeded inputs at the shapes of the 2^20-point paths,
   requires every output digit to be equal, and times both with CUDA
   events (the grouped sum at the shapes of both reduction passes,
   `padd_masked` also at every level of the naive engine's tree sum,
   `finish_affine_divsteps` on K 20 windows with one z = 0). Runs
   `finish_affine_divsteps` over 65 536 random Montgomery residues as z
   after the edge values 0, 1, 2, p - 1, p - 2, R mod p and R^2 mod p,
   digit for digit its plain version's on the edge values and the first
   1 017 random ones, and counts the divstep batches this run's z need,
   which its operations bound uses.
   Holds the six kernels of the device-resident path the same way at its
   2^20 shapes (w 16 in one batch of C 2048 x L 512: `to_niels` over 2^20
   points, the gathering scan at L 512 x W 32 768, `lane_scan` at K 16,
   `assemble_buckets` over K 16 x B 32 800 buckets without a carry,
   `grouped_running_sum` at [32, 4, 16, 16 400], `reduce_finish` at 1 025
   groups a window, `finish_affine_divsteps` at K 16), and the tensor-core gathering
   scan (`accumulate_scan_gather(use_mma=True)`) at the gathering scan's
   shape: rows labelled "[resident 2^20]". Prints each kernel's ptxas line with
   its occupancy (warps an SM) where the library reports one.
4. Drives every path with the launch counts set to 0 just before and read
   just after; each path names the kernels it must and must not launch:
   - the wire `compute_msm` on the pinned 2^16-2^20 inputs (each power
     regenerated from its seeds, the host's time printed), each against
     its `PINNED` result, and at 2^20 cold and warm, with a profile of the
     warm call and its host dispatch time (the host's clock until
     `_dispatch_wire` has queued the whole call, without a sync);
   - lists: `compute_msm` on the same 2^20 points and scalars as lists of
     `ExtPoint`s and ints, which the API marshals to wire rows (the
     marshal timed apart) for the wire path's kernels;
   - the fixed-base plan: `MSMPlan` once, then `msm_batch` of three 2^20
     scalar jobs, against the pinned result and the wire path's;
   - `compute_msm_batch` at 2^16 with one shared point array (the plan
     branch) and with distinct arrays (the batched wire path);
   - `compute_msm` at 2^16 with every scalar equal to one s, against the
     oracle's s * (sum of the points): every window is one bucket over all
     its lanes, so every level of the lane scan adds;
   - a fixture round trip: `distinct_case(4096, seed=11)` written with
     `save_test_case`, read back with `load_test_case` (its expected
     result recomputed by the oracle) and run through the wire
     `compute_msm`, against the case's expected result;
   - the A/B path of the tensor-core scan: the CIOS scan and the
     tensor-core scan at the production shape, in turns, required equal;
     then the gathering pair, the CIOS and the tensor-core gathering
     scans at the resident shape (L 512 x W 32 768), in turns, required
     equal on all three outputs;
   - the hybrid engine on the 2^20 wire input at `cpu_work_ratio` 0.2
     (cold and warm, and its CPU and GPU shares alone) and at 1.0 (the
     native engine alone, no kernel), and on the 2^16 lists at 0.2 (both
     shares on the marshalled wire rows);
   - `engine="cpu"` on the 2^16 lists (no kernel);
   - `engine="baseline"` at 2^16 (no kernel), with its host bucketing,
     device ladder and host combine timed apart;
   - routing at 2^16: `MSMPlan` on the hybrid engine or with a split keeps
     no resident bases and gives the wire calls' results, and
     `compute_msm_batch` with a split gives per-call `compute_msm`'s;
   - the device-resident plan at 2^20: the pinned inputs as plain digit
     planes and scalar words on the card, `_device_msm` with the rules
     `resolved_window_size` / `resolved_chunking` (w 16, C 2048 x L 512),
     one launch each of its six kernels and no other, cold and warm, with
     no synchronizing call before the finish (PyTorch's sync check), a
     profile and the peak device memory; `msm_window_sums` on the same
     points gives the same window sums as points;
   - a full MSM through the tensor-core gathering scan: the same pinned
     2^20 input's scan arguments at the resident plan, built as the
     preamble of `pippenger._accumulate_batch` builds them (digits, the
     stable sort, the lanes), then `accumulate_scan_gather(use_mma=True)`,
     `lane_scan`, `assemble_buckets`, `reduce_and_finish` and the host
     combine, against `PINNED[20]`, one launch each and no CIOS scan;
   - the bucket reduction at every group size at the resident shape: the
     2^20 pinned input's bucket sums after one `accumulate_buckets` (w 16
     signed, K 16, B 32 800) through `reduce_and_finish(group_size=Gs)` for
     Gs 1, 2, 4, 8, 16 and 32, each giving `PINNED[20]` and the same affine
     window sums, Gs 1 with 2 * ceil(log2 B) = 32 `padd_masked` launches
     (the suffix scan) and no grouped kernel, every other Gs with one
     `grouped_running_sum` and one `reduce_finish`, first and warm wall;
     the Gs 1 path against the same levels on `padd_masked`'s plain
     version, and `padd_masked` at the suffix scan's shape and the Gs 4
     kernels held against their plain versions (rows "[suffix scan
     2^20]" and "[reduce Gs 4 2^20]");
   - the multi-GPU layer (`parallel/`) at 2^20 on the same points, w 16
     signed: one NCCL rank (`distributed.init` with world size 1 on a local
     coordinator, `global_mesh`, `msm_window_sums_sharded` with one shard of
     C 2048 x L 512) and `_multihost_worker 0 1 --device cuda` in a
     subprocess (it must print MULTIHOST_OK, having captured its stage
     graphs and held a replayed and an eager call digit for digit to its
     first; its captures precede its collective); virtual meshes of D 2 and 4
     shards on cuda:0 (C 2048 x L 512 / D a shard) in both collective
     modes, each with the gathering scan, `lane_scan` and
     `assemble_buckets` once a shard, the reduction once a shard
     ("window_sums") or once ("buckets"), `padd_masked` (D - 1).bit_length()
     times (the tree combine) and no other kernel, no synchronizing call
     before the result is read, cold and warm wall, busy time, launches and
     peak memory, every call through the stage graphs and digit for digit
     the `eager()` call's (`graph_ab` for NCCL world 1, without the sync
     check, and for D 4 in both modes); `ShardedFixedBasePlan` at D 4 with
     two jobs of the
     benchmark's repeated-base case (sum(s) * B; no `to_niels`, no
     `pack_rows`); `padd_masked` held against its plain version at the
     buckets-mode tree's shape [4, 16, 2 099 200] (row "[sharded 2^20]");
     `scaling.print_report` against the resident call's warm time, with the
     virtual weak-scaling trend at D 1, 2, 4 of 2^18 points a shard;
   - the window sweep at 2^20: the wire `compute_msm` on the benchmark's
     repeated-base case at every w of 8-20, signed and unsigned (26 calls,
     printed as one JSON line with each wire plan), and the resident rule
     at w 13-17 on the same inputs;
   - a trace summary (`utils/trace.py`) of one warm 2^20 wire call;
   - the stage graphs (`utils/cache.py`) on the wire, plan,
     resident, sharded and `device_affine` paths at 2^20 (`graph_ab`):
     the cold call at a new key, then the graphs and `eager()` in turns
     on the same inputs, every output
     digit for digit equal and the expected result; a warm graph call
     under PyTorch's sync check; per mode the warm wall, host queueing,
     busy time, idle share, device launches, host launch calls and peak
     memory; three wire jobs queued before any fetch, each its own
     result; the graphs' bytes within their limit after every sweep call;
   - `device_affine`, the 2^20 wire call with the affine finish on the
     card: the wire kernels and `finish_affine_divsteps` once a call, the
     plain `finv_mont` made to raise,
     `PINNED[20]`, cold and warm wall, and its `graph_ab` (the finish one
     graph, `finish_affine_w13_s1`; fewer than 2 000 device launches a
     call in either mode); the resident call with `device_affine` (phase
     4o) launches `finish_affine_divsteps` once at K 16, a warm graph
     call and an eager call give its digits, and it is timed in turns
     with the call without `device_affine`;
   - last, as it profiles about 10^5 plain kernels (after which this
     machine's profiler drops some records): `engine="naive"`
     at 2^16: `padd_masked` once a level of its tree sum,
     (pad_to - 1).bit_length() launches, and no other kernel; its device
     launches from profiles of one and two ladder steps.
   Every result must be the pinned one or, where none is pinned, the wire
   path's on the same inputs (or the oracle's). Every GPU `compute_msm` path
   launches the gathering scan, `lane_scan` and `assemble_buckets` once a
   batch, and neither `padd_masked`, `padd` nor a tensor-core scan; every
   wire path and plan
   build launches `to_niels_xy_rows` once a base batch and `to_niels_xy`
   never. A stage graph's replay counts the launches its capture
   recorded; every graph's kernel nodes, by symbol as the CUDA driver
   reads them from the graph, must equal those launches.
5. Prints the kernel table as one JSON line, then the result line.

Any failure raises, and the script exits non-zero. It imports nothing of
JAX; it needs the repository's `webgpu_msm_tpu_torch` package beside it.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# The card has no listed integer-ALU peak, and the non-tensor float32 peak
# (67 TFLOP/s) is about four times what it issues in 32-bit integer
# multiplies. The operations bound therefore uses the rate that
# `mad_rate_per_s` measures in this run.
# 32-bit multiplies in one 8-limb CIOS Montgomery product (a*b: 64,
# m*p: 64, m: 8), two operations (low and high word) each.
OPS_PER_MONT_MUL = 2 * (64 + 64 + 8)
# from_mont is one Montgomery reduction: its m*p and m halves, no a*b.
OPS_PER_MONT_REDUCE = 2 * (64 + 8)
PALLAS = "webgpu_msm_tpu/ops/pallas/"
CSRC = "webgpu_msm_tpu_torch/ops/kernels/csrc/"
WIRE_KERNELS = ("to_niels_xy_rows", "accumulate_scan_gather", "lane_scan", "assemble_buckets",
                "grouped_running_sum", "reduce_finish")
BATCH_KERNELS = ("accumulate_scan_gather", "lane_scan", "assemble_buckets")  # one launch a batch
# The device-resident path at 2^20: one batch, one launch of each.
RESIDENT_KERNELS = ("to_niels", "accumulate_scan_gather", "lane_scan", "assemble_buckets",
                    "grouped_running_sum", "reduce_finish")
RESIDENT = " [resident 2^20]"  # the label of the kernel rows at the resident path's shapes
SHARDED = " [sharded 2^20]"  # the label of the tree combine's row at the sharded path's shape
SUFFIX = " [suffix scan 2^20]"  # padd_masked at the suffix scan's shape (Gs 1, resident buckets)
GS4 = " [reduce Gs 4 2^20]"  # the grouped kernels at Gs 4 over the resident buckets
REDUCE_GROUP_SIZES = (1, 2, 4, 8, 16, 32)
# The affine finish's least work, by the cheaper of its algorithms: over
# this run's K' nonzero z, Montgomery's trick (K' - 1 prefix products,
# one inverse of their product, 2 (K' - 1) products back to each z's
# inverse) with that one inverse by divsteps (CHES 2019;
# `finish_affine_divsteps`): batches of DIVSTEP_BATCH divsteps until g =
# 0, as many as this product needs (`divstep_batches`). The divsteps
# multiply nothing; each batch applies its 2x2 matrix to f and g (4 x 9
# limb products) and to d and e (4 x 9, and 2 x 9 for the multiples of
# p), 32x32->64 multiplies of two operations each. Then the inverse by
# R^2 and x, y by each z's inverse: 5 K' - 2 products in all. Both
# kernels' rows use this count (`finish_least_work`).
DIVSTEP_BATCH = 30
OPS_PER_DIVSTEP_BATCH = 2 * (4 * 9 + 4 * 9 + 2 * 9)
# The divstep kernel's own products a window (no trick: each thread
# inverts its z): the inverse by R^2, x and y by that. Its per-window
# count, kept in its rows as `per_window_ops`.
FINISH_AFFINE_PRODUCTS = 3
# The resident call with and without `device_affine`: rounds of turns.
AFFINE_TURNS = 6
# The wide check of the divstep kernel: this many random windows beside
# the edge values of z.
WIDE_WINDOWS = 1 << 16
MAD_PROBE = """
#include <cuda_runtime.h>
// Eight independent mad.lo.u32 chains a thread: nothing but multiply issue.
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


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def field_planes(gen: torch.Generator, lead: tuple, width: int) -> torch.Tensor:
    """Random canonical field elements as [*lead, 16, width] int32 digits
    (top digit below p's, so every value is below p)."""
    d = torch.randint(0, 1 << 16, lead + (16, width), generator=gen, dtype=torch.int32)
    d[..., 15, :] = torch.randint(0, 0x12AB, lead + (width,), generator=gen, dtype=torch.int32)
    return d


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def quartiles(xs: list) -> list:
    """The first quartile, the median and the third quartile of xs."""
    return [float(q) for q in statistics.quantiles(xs, n=4, method="inclusive")] if len(xs) > 1 else list(xs) * 3


def once_ms(fn):
    """One call, synchronized: (result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    check(a.shape == b.shape and a.dtype == b.dtype, f"shape/dtype {a.shape} {b.shape}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def kernel_inputs(gen: torch.Generator, dev, M=1 << 18, K=20, C=2048, L=128, B=4128,
                  Gs=32, top=65, carry=True, names=None) -> dict:
    """Seeded inputs at the main path's shapes (by default those of 2^20
    points: w = 13 signed, batches of M = 2^18, C = 2048, L = 128, so
    K = 20 windows, B = 4128 buckets and Gs = 32), for the kernels in
    `names` (every kernel by default). `top`: the top window's bucket ids
    lie in [0, top); `carry`: whether `assemble_buckets` adds into one."""
    want = lambda *ks: names is None or any(k in names for k in ks)
    W, G = K * C, B // Gs
    as_i32 = lambda t: torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)
    pts = lambda lead, width: field_planes(gen, lead, width).to(dev)
    lanes = lambda t: as_i32(t).reshape(K, C, L).permute(2, 0, 1).reshape(L, W).contiguous().to(dev)
    if want("accumulate_scan", "accumulate_scan_mma"):
        # Sorted bucket ids per lane with random signs: runs of varying length.
        ids = torch.sort(torch.randint(0, B, (W, L), generator=gen), dim=1).values.t()
        signs = torch.randint(0, 2, (L, W), generator=gen) << 31
        ids = (ids | signs).contiguous()
        niels = field_planes(gen, (3,), L * W).to(torch.int64).reshape(3, 16, L, W)
        packed = niels[:, 0::2] | (niels[:, 1::2] << 16)
        scan = (as_i32(packed).contiguous().to(dev), as_i32(ids).to(dev))
    if want("accumulate_scan_gather", "accumulate_scan_gather_mma"):
        # The gathering scan's input as a batch stage makes it: signed digits
        # of C * L points per window, sorted, with the sort's permutation;
        # packed rows.
        digits = torch.randint(0, B, (K, C * L), generator=gen)
        order = torch.sort(digits, dim=1, stable=True).indices
        sorted_ids = torch.gather(digits | (torch.randint(0, 2, (K, C * L), generator=gen) << 31), 1, order)
        row_planes = field_planes(gen, (3,), C * L).to(torch.int64)
        rows = as_i32(row_planes[:, 0::2] | (row_planes[:, 1::2] << 16)).reshape(24, C * L).t().contiguous()
    if want("lane_scan", "assemble_buckets"):
        # The lane scan's and the bucket assembly's inputs as a batch stage
        # makes them: each window's ids sorted, the top window's from
        # [0, top) (253-bit scalars leave 6 bits and the signed carry to
        # window 19 of w = 13: 65), so that its buckets span many lanes;
        # final_id is the id of each lane's last step, sign bit stripped.
        ldigits = torch.randint(0, B, (K, C * L), generator=gen)
        ldigits[-1] = torch.randint(0, min(top, B), (C * L,), generator=gen)
        ldigits = torch.sort(ldigits, dim=1).values
        hist = torch.stack([torch.bincount(d, minlength=B) for d in ldigits])
        e_pos = torch.cumsum(hist, dim=1)
        final_id = ldigits[:, L - 1 :: L].reshape(W)
    if want("to_niels_xy_rows"):
        # Wire x||y rows of raw u32 words, most of them above p.
        xy_rows = torch.randint(-(1 << 31), 1 << 31, (M, 16), generator=gen, dtype=torch.int32)
    builders = {
        "to_niels_xy": lambda: (pts((2,), M),),
        "to_niels": lambda: (pts((3,), M),),
        "accumulate_scan": lambda: scan,
        "accumulate_scan_mma": lambda: scan,
        "padd_masked": lambda: (
            pts((4,), W), pts((4,), W),
            torch.randint(0, 2, (W,), generator=gen, dtype=torch.int32).to(dev),
        ),
        "padd": lambda: (pts((4,), K * B), pts((4,), K * B)),
        "grouped_running_sum": lambda: (pts((Gs, 4), K * G),),
        "grouped_running_sum pass 2": lambda: (pts((G, 4), 2 * K),),
        "accumulate_scan_gather": lambda: (rows.to(dev), lanes(order), lanes(sorted_ids), K, B),
        "accumulate_scan_gather_mma": lambda: (rows.to(dev), lanes(order), lanes(sorted_ids), K, B),
        "reduce_finish": lambda: (pts((4,), K * G), pts((4,), K * G), K, Gs.bit_length() - 1),
        "lane_scan": lambda: (pts((4,), W), final_id.to(torch.int32).to(dev), K),
        "assemble_buckets": lambda: (pts((4,), K * B), pts((4,), W), hist.to(torch.int32).to(dev),
                                     e_pos.to(torch.int32).to(dev), L,
                                     pts((4,), K * B) if carry else None),
        "to_niels_xy_rows": lambda: (xy_rows.to(dev),),
        "finish_affine_divsteps": lambda: (mont_sums(gen, K).to(dev),),
    }
    return {k: f() for k, f in builders.items() if want(k)}


def mont_sums(gen: torch.Generator, K: int) -> torch.Tensor:
    """Montgomery window sums [4, 16, K] below p, as `reduce_finish` writes
    them, with z = 0 in window 1 (mapped to (0, 0))."""
    sums = field_planes(gen, (4,), K)
    sums[3, :, 1] = 0
    return sums


def window_ints(plane: torch.Tensor) -> list:
    """[16, K] digit planes -> the K field elements as ints."""
    d = plane.cpu().to(torch.int64).tolist()
    return [sum(d[i][k] << (16 * i) for i in range(16)) for k in range(len(d[0]))]


def divstep_batches(z: int) -> int:
    """Batches of DIVSTEP_BATCH divsteps until g = 0 for the inverse of z
    (f = p, g = z, delta = 1/2), as `finish_affine_divsteps` runs them."""
    from webgpu_msm_tpu_torch.oracle.field import P

    f, g, zeta, steps = P, z, -1, 0
    while g:
        if zeta < 0 and g & 1:
            f, g, zeta = g, (g - f) >> 1, -zeta - 2
        elif g & 1:
            g, zeta = (g + f) >> 1, zeta - 1
        else:
            g, zeta = g >> 1, zeta - 1
        steps += 1
    return -(-steps // DIVSTEP_BATCH)


def finish_least_work(zs: list) -> tuple[int, int]:
    """The affine finish's least work for the Montgomery residues zs (the
    z plane): (divstep batches of the one inverse, Montgomery products) by
    Montgomery's trick over the nonzero z (the comment at DIVSTEP_BATCH)."""
    from webgpu_msm_tpu_torch.oracle.field import P, R

    nonzero = [z for z in zs if z % P]
    if not nonzero:
        return 0, 0
    r_inv, prod = pow(R, -1, P), nonzero[0]
    for z in nonzero[1:]:  # the prefix products, as Montgomery products
        prod = prod * z * r_inv % P
    return divstep_batches(prod), 5 * len(nonzero) - 2


def divstep_stats(mont: torch.Tensor) -> dict:
    """The divstep batches that Montgomery window sums [4, 16, K] need: in
    all and at most a window, the divstep kernel's operations a window at
    that (`per_window_ops`), and the least work the bound counts."""
    zs = window_ints(mont[3])
    batches = [divstep_batches(z) for z in zs]
    least_batches, least_products = finish_least_work(zs)
    return {"divstep_batches": sum(batches), "most_batches_a_window": max(batches),
            "per_window_ops": sum(batches) * OPS_PER_DIVSTEP_BATCH
            + len(zs) * FINISH_AFFINE_PRODUCTS * OPS_PER_MONT_MUL,
            "least_work_ops": least_batches * OPS_PER_DIVSTEP_BATCH + least_products * OPS_PER_MONT_MUL}


def wide_inverse_check(pk, gen: torch.Generator, dev, smi: str) -> dict:
    """The divstep kernel over WIDE_WINDOWS random Montgomery residues as z
    after the edge values 0, 1, 2, p - 1, p - 2, R mod p and R^2 mod p: on
    the first 1 024 windows (the edge values among them) digit for digit
    the plain version's, and the same digits there when those windows are
    launched alone; timed at the whole width."""
    from webgpu_msm_tpu_torch.oracle.field import P, R

    edges = (0, 1, 2, P - 1, P - 2, R % P, R * R % P)
    mont = field_planes(gen, (4,), len(edges) + WIDE_WINDOWS)
    for lane, z in enumerate(edges):
        mont[3, :, lane] = torch.tensor([(z >> (16 * i)) & 0xFFFF for i in range(16)], dtype=torch.int32)
    mont = mont.to(dev)
    got = pk.finish_affine_divsteps(mont)
    head = mont[..., :1024].contiguous()
    check(torch.equal(got[..., :1024], pk.finish_affine_plain(head)),
          "finish_affine_divsteps differs from its plain version on the first 1 024 wide windows")
    check(torch.equal(pk.finish_affine_divsteps(head), got[..., :1024]),
          "finish_affine_divsteps: the first 1 024 windows differ when launched alone")
    check(not got[:, :, 0].any(), "finish_affine_divsteps: z = 0 not mapped to (0, 0)")
    ms = cuda_ms(lambda: pk.finish_affine_divsteps(mont), 10)
    print(f"kernel finish_affine_divsteps: over {mont.shape[-1]} windows (the edge values of z first, then random "
          f"residues) equal to plain on the first 1 024; {ms:.4f} ms at that width [{smi}]")
    return {"wide_windows": mont.shape[-1], "wide_ms": ms}


def tree_sum_levels(gen: torch.Generator, dev, W: int, padd_masked) -> list:
    """`padd_masked`'s arguments at each level of the naive engine's tree sum
    over W lanes (`pippenger._tree_sum_axis`): (a, a rolled by -d, lane +
    d < W) for d = 1, 2, 4, ... < W, each level's a the sum before it."""
    a = field_planes(gen, (4,), W).to(dev)
    lane = torch.arange(W, device=dev)
    levels = []
    for i in range((W - 1).bit_length()):
        d = 1 << i
        b, mask = torch.roll(a, -d, dims=-1), (lane + d < W).to(torch.int32)
        levels.append((a, b, mask))
        a = padd_masked(a, b, mask)
    return levels


def mad_rate_per_s(build) -> float:
    """32-bit integer multiply-adds a second that the card issues, measured:
    independent `mad.lo.u32` chains on every SM (MAD_PROBE above)."""
    src = build.BUILD_DIR / "mad_rate_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(MAD_PROBE)
    nvcc = shutil.which("nvcc") or str(build.NVCC_DEFAULT)
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(src.with_suffix(".so")), str(src)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(src.with_suffix(".so")))
    lib.launch_mad_rate_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    n_blocks, threads, iters = 132 * 16, 256, 4096
    out = torch.zeros(n_blocks * threads, dtype=torch.int32, device="cuda")
    src_words = torch.tensor([12345, 678], dtype=torch.int32, device="cuda")

    def launch():
        rc = lib.launch_mad_rate_probe(out.data_ptr(), src_words.data_ptr(), n_blocks, threads,
                                       iters, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"mad_rate_probe: launch failed ({rc})")

    return n_blocks * threads * iters * 8 / (cuda_ms(launch, 5) * 1e-3)


def hold(kname: str, kern, plain, args, reps: int, ops_per_s: float, replaces: str, source: str,
         smi: str, label: str = "") -> dict:
    """The kernel against its plain version on `args` (every digit equal),
    its CUDA-event time and its bound: its row of the kernel table."""
    got, _ = once_ms(lambda: kern(*args))
    want, plain_ms = once_ms(lambda: plain(*args))
    err = max_abs_err(got, want)
    check(err == 0, f"{kname}{label}: kernel differs from its plain version (max abs err {err})")
    del got, want
    ms = cuda_ms(lambda: kern(*args), reps)
    bound_ms, bound_by = bound(kname, args, ops_per_s)
    print(f"kernel {kname}{label}: equal to plain on {tuple(args[0].shape)}; {ms:.4f} ms "
          f"(plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms by {bound_by}) [{smi}]")
    return {
        "name": kname + label, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def bound(name: str, args, ops_per_s: float) -> tuple[float, str]:
    """Least time for the work these inputs need: (ms, "bytes"|"operations").
    Bytes: every input read once and every output written once, over the
    card's memory rate. Operations: the Montgomery products of the function,
    OPS_PER_MONT_MUL 32-bit multiplies each (a from_mont reduction counts
    as OPS_PER_MONT_REDUCE of them), over the measured multiply rate."""
    nbytes = sum(a.numel() * 4 for a in args if isinstance(a, torch.Tensor))
    if name == "to_niels_xy":
        M = args[0].shape[-1]
        nbytes += 3 * 16 * M * 4
        muls = 4 * M
    elif name == "to_niels_xy_rows":  # 64 B in (counted above), 96 B out a point
        M = args[0].shape[0]
        nbytes += 24 * M * 4
        muls = 4 * M
    elif name == "to_niels":
        nbytes += args[0].numel() * 4
        muls = 3 * args[0].shape[-1]
    elif name in ("accumulate_scan", "accumulate_scan_mma"):  # the same work
        _, _, L, W = args[0].shape
        nbytes += (64 * L * W + 64 * W + W) * 4
        muls = 7 * L * W
    elif name in ("accumulate_scan_gather", "accumulate_scan_gather_mma"):  # the same work
        _, _, ids, K, B = args
        L, W = ids.shape
        # The row table read once (the card's L2 holds it over the K
        # re-reads of each row). Outputs: final_acc, final_id, partial.
        nbytes += (64 * W + W + 64 * K * B) * 4
        muls = 7 * L * W
    elif name == "lane_scan":
        # The adds the masks imply, level by level (the kernel copies the
        # other lanes); output: the scanned lanes.
        _, final_id, K = args
        W = final_id.numel()
        ids, lane = final_id.reshape(K, W // K), torch.arange(W // K, device=final_id.device)
        adds = sum(int(((lane >= 1 << i) & (torch.roll(ids, 1 << i, dims=-1) == ids)).sum())
                   for i in range(max((W // K - 1).bit_length(), 1)))
        nbytes += 64 * W * 4
        muls = 9 * adds
    elif name == "assemble_buckets":
        # Of the lane totals only the picked lanes are read; two adds a
        # bucket with a carry, identities included; output: one point a bucket.
        partial, carries, hist, e_pos, L, carry = args
        picked = int(((e_pos // L - 1) >= (e_pos - hist) // L).sum())
        nbytes += (64 * picked - carries.numel() + partial.numel()) * 4
        muls = 9 * (1 if carry is None else 2) * partial.shape[-1]
    elif name == "padd_masked":
        nbytes += args[0].numel() * 4
        muls = 9 * int((args[2] != 0).sum())
    elif name == "padd":
        nbytes += args[0].numel() * 4
        muls = 9 * args[0].shape[-1]
    elif name == "finish_affine_divsteps":
        # one divstep inverse and 5 K' - 2 products (`finish_least_work`);
        # output: [2, 16, K]
        nbytes += 2 * 16 * args[0].shape[-1] * 4
        batches, products = finish_least_work(window_ints(args[0][3]))
        muls = batches * OPS_PER_DIVSTEP_BATCH / OPS_PER_MONT_MUL + products
    elif name == "reduce_finish":
        T, _, K, doublings = args
        G = T.shape[-1] // K
        nbytes += 2 * 64 * K * 4
        # sum_g g*T_g (2G - 1 adds), sum_g U_g (G - 1), the doublings (8
        # products each), one add and four from_mont (reductions), per window.
        muls = K * (9 * (3 * G - 2) + 8 * doublings + 9 + 4 * OPS_PER_MONT_REDUCE / OPS_PER_MONT_MUL)
    else:  # grouped_running_sum: the serial chain's adds are the least work
        Gs, _, _, W = args[0].shape
        nbytes += 2 * 64 * W * 4
        muls = 9 * (2 * Gs - 1) * W
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = muls * OPS_PER_MONT_MUL / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_call(label: str, fn, warm_ms: float, top: int = 12):
    """Where one warm 2^20 call's device time goes: the busiest device ops,
    the number of device launches, and the device's busy share of the
    unprofiled warm wall time; returns (busy ms, launches), or None if the
    profiler recorded no device kernel. Fails if gather kernels take more
    than 2 ms: the scan gathers its rows itself, and the plain row gather
    that fed the dense scan took 12.6 ms a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda e: e.self_device_time_total
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"profile {label}: the profiler recorded no device kernels")
        return None
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"profile {label}: device busy {busy_ms:.1f} ms of a {warm_ms:.1f} ms warm call "
          f"(idle share {1 - busy_ms / warm_ms:.3f}), {sum(e.count for e in events)} device launches")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"profile {label}:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    gather_ms = sum(dev_us(e) for e in events if "gather" in e.key and "accumulate_scan" not in e.key) / 1e3
    print(f"profile {label}: plain gather kernels {gather_ms:.3f} ms")
    check(gather_ms < 2.0, f"{label}: plain gather kernels take {gather_ms:.3f} ms")
    return busy_ms, sum(e.count for e in events)


def host_dispatch(api, gpu_engine, fn):
    """One synchronized wire call `fn`: (result, host ms until the engine's
    `_dispatch_wire` returned, having queued every copy and kernel without a
    sync, wall ms, {host step: ms}). The steps are the API's z check, the
    writes of x||y and scalar rows into pinned memory (two a batch, as the
    batches are streamed), and the rest of the dispatch, mostly queueing
    the copies and launches."""
    steps = {"z check": (api, "_wire_point_rows"), "rows into pinned": (gpu_engine._Staged, "rows"),
             "dispatch": (gpu_engine, "_dispatch_wire")}
    with timed_steps(steps, sync=False) as spent:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    check(len(spent["z check"]) == len(spent["dispatch"]) == 1 and len(spent["rows into pinned"]) % 2 == 0,
          f"the wire call's host steps ran {spent}")
    ms = {name: sum(end - start for start, end in v) * 1e3 for name, v in spent.items()}
    ms["rest of dispatch (queueing copies and launches)"] = ms.pop("dispatch") - ms["rows into pinned"]
    return out, (spent["dispatch"][0][1] - t0) * 1e3, (t1 - t0) * 1e3, ms


@contextlib.contextmanager
def timed_steps(steps: dict, sync: bool):
    """Wrap each (module, attribute) function of `steps` while the block
    runs; yields {step: [(start, end) host clock of each call]}. With
    `sync` the device is synchronized before and after each call, so that a
    device step's time is its own."""
    spent = {name: [] for name in steps}
    originals = {name: getattr(mod, attr) for name, (mod, attr) in steps.items()}

    def timed(name):
        def call(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = originals[name](*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            spent[name].append((t, time.perf_counter()))
            return out
        return call

    for name, (mod, attr) in steps.items():
        setattr(mod, attr, timed(name))
    try:
        yield spent
    finally:
        for name, (mod, attr) in steps.items():
            setattr(mod, attr, originals[name])


def queued_without_sync(label: str, fn):
    """Run fn once with PyTorch's synchronization check on and no sync
    around it: nothing on the call may wait for the device. Returns (its
    result, host ms to queue it)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            out = fn()
            queued_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    check(not syncs, f"{label}: the call synchronized with the device: {syncs}")
    return out, queued_ms


def free_port() -> int:
    """A free TCP port on the loopback, for a local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def profile_counts(fn) -> tuple[float, int, int]:
    """What the profiler records while fn runs: (device busy ms, NaN if no
    device kernel was recorded; device kernels and copies; host calls of
    the CUDA runtime that launch a kernel or a graph or queue a copy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_device) / 1e3 if on_device else float("nan")
    host = sum(e.count for e in events if e.device_type == DeviceType.CPU and e.key.startswith("cuda")
               and any(k in e.key for k in ("Launch", "Memcpy", "Memset")))
    return busy, sum(e.count for e in on_device), host


def graph_ab(label: str, graphs, run, check_out, smi: str, sync_check: bool = True) -> dict:
    """One path with the stage graphs and under `graphs.eager()`, on the
    same inputs. run(): the path's dispatch, returning its window sums on
    the card without a sync; check_out(out) fails unless they give the
    expected result. First the cold call at a new key (every graph dropped;
    the kernels and constants already loaded), then graph, eager, eager,
    graph in turns, every output digit for digit equal; a warm graph call
    under PyTorch's sync check (unless `sync_check` is False: a path whose
    collective synchronizes); then, per mode, the peak device memory and a
    profile. Prints the numbers, and the keys left eager past half the
    graphs' limit, and returns them."""
    graphs.clear()
    out, cold_ms = once_ms(run)
    check_out(out)
    captured = graphs.stats()
    outs, walls, queued, replays = [], {True: [], False: []}, {True: [], False: []}, 0
    for use_graphs in (True, False, False, True):
        with contextlib.nullcontext() if use_graphs else graphs.eager():
            before = graphs.stats()["replays"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls[use_graphs].append((time.perf_counter() - t0) * 1e3)
            queued[use_graphs].append((t1 - t0) * 1e3)
            replays = graphs.stats()["replays"] - before if use_graphs else replays
        outs.append(out)
    for out in outs:
        check(torch.equal(out, outs[0]), f"{label}: the graph and the eager outputs differ")
        check_out(out)
    check(graphs.stats()["captures"] == captured["captures"], f"{label}: a warm call captured")
    if sync_check:
        out, _ = queued_without_sync(f"{label} (graphs, warm)", run)
        check(torch.equal(out, outs[0]), f"{label}: the sync-checked call differs")
    report = {"cold_new_key_ms": cold_ms, "captures": captured["captures"], "replays_a_call": replays,
              "graph_bytes": graphs.stats()["bytes"], "too_large": graphs.stats()["too_large"]}
    for use_graphs in (True, False):
        with contextlib.nullcontext() if use_graphs else graphs.eager():
            torch.cuda.reset_peak_memory_stats()
            once_ms(run)
            peak = torch.cuda.max_memory_allocated() / 1e9
            peak_reserved = torch.cuda.max_memory_reserved() / 1e9
            busy, dev_launches, host_calls = profile_counts(run)
        warm = min(walls[use_graphs])
        report["graphs" if use_graphs else "eager"] = {
            "warm_ms": warm, "walls_ms": walls[use_graphs], "queued_ms": min(queued[use_graphs]),
            "busy_ms": busy, "idle_share": 1 - busy / warm, "device_launches": dev_launches,
            "host_launch_calls": host_calls, "peak_gb": peak, "peak_reserved_gb": peak_reserved}
    g, e = report["graphs"], report["eager"]
    print(f"{label} graphs/eager: digit-exact over graph, eager, eager, graph; "
          + ("no synchronizing call on a warm graph call; " if sync_check else "")
          + f"cold at a new key {cold_ms:.1f} ms ({captured['captures']} captures), "
          f"{replays} replays a warm call, graphs hold {report['graph_bytes'] / 1e9:.3f} GB, left eager past "
          f"half the limit: {report['too_large']} [{smi}]")
    for mode, r in (("graphs", g), ("eager", e)):
        print(f"{label} {mode}: warm {r['warm_ms']:.2f} ms (runs {', '.join(f'{x:.2f}' for x in r['walls_ms'])}), "
              f"host queueing {r['queued_ms']:.2f} ms, device busy {r['busy_ms']:.2f} ms, idle share "
              f"{r['idle_share']:.3f}, {r['device_launches']} device launches, {r['host_launch_calls']} host "
              f"launch/copy calls, peak device memory {r['peak_gb']:.3f} GB allocated (the graphs' pools "
              f"apart), {r['peak_reserved_gb']:.3f} GB reserved [{smi}]")
    print(json.dumps({"graph_ab": label, **report, "card": smi}))
    return report


def naive_device_launches(naive_engine, gpu_engine, points, scalars, pad_to, dev) -> int:
    """The naive engine's device launches at its ladder's full length, from
    profiles of its device stage with one and with two ladder steps (every
    step launches the same kernels, whatever the scalars): a profile of
    the whole 256 steps would record millions of events."""
    pts = gpu_engine._host_tensor(gpu_engine.marshal_points(points, pad_to), dev).to(dev)
    sc = gpu_engine._host_tensor(gpu_engine.marshal_scalars(scalars, pad_to), dev).to(dev)
    full = naive_engine.SCALAR_BITS
    counts = {}
    try:
        for steps in (1, 2):
            naive_engine.SCALAR_BITS = steps
            counts[steps] = profile_counts(lambda: naive_engine._device_naive(pts, sc))[1]
    finally:
        naive_engine.SCALAR_BITS = full
    return counts[1] + (full - 1) * (counts[2] - counts[1])


class _KernelNodeParams(ctypes.Structure):  # the driver's CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint), ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernel_nodes(graph) -> dict[str, int]:
    """{kernel symbol: kernel nodes} of a captured CUDA graph (made with
    keep_graph=True), as the CUDA driver reads them from the graph."""
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(res: int, call: str) -> None:
        check(res == 0, f"{call} returned CUresult {res}")

    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts: dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int()
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        ok(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
           "cuGraphKernelNodeGetParams")
        if params.func:
            ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)), "cuKernelGetName")
        counts[name.value.decode()] = counts.get(name.value.decode(), 0) + 1
    return counts


def hold_graphs_to_their_kernels(stage_graphs, pk) -> list:
    """From here on, every stage graph is captured with its template kept
    and checked before it is instantiated: its kernel nodes, by symbol as
    the driver reads them, must equal the wrapper launches that its capture
    recorded, which each replay of it adds to the counts. (The profiler is
    not the check: on this machine it drops some kernel records of graph
    replays, PERF.md, PR 13.) Returns [(stage, {kernel: nodes})] of the
    graphs checked."""
    real_graph, real_capture = torch.cuda.CUDAGraph, stage_graphs._capture
    checked = []

    def capture(fn, inputs, device):
        before = dict(pk.launches)
        graph, output = real_capture(fn, inputs, device)
        recorded = {k: pk.launches[k] - before[k] for k in pk.KERNELS}
        nodes = graph_kernel_nodes(graph)
        on_graph = {k: nodes.pop(f"{k}_kernel", 0) for k in pk.KERNELS}
        check(on_graph == recorded, f"a stage graph's kernel nodes {on_graph} differ from the launches its "
                                    f"capture recorded {recorded}")
        graph.instantiate()
        checked.append({k: v for k, v in on_graph.items() if v})
        return graph, output

    torch.cuda.CUDAGraph = lambda: real_graph(keep_graph=True)
    stage_graphs._capture = capture
    return checked


def drive(label: str, pk, fn, must: tuple, must_not: tuple, batches: int = 0,
          conversions: int | None = None):
    """One path: launch counts set to 0, the path driven once and
    synchronized, counts read. Returns (result, wall ms, counts); fails
    unless every kernel in `must` was launched and none in `must_not`, and,
    for a `compute_msm` path of `batches` batch stages, unless each batch
    kernel was launched once a batch; with `conversions`, unless the wire
    input stage ran that many times (once a base batch). A stage graph's
    replay counts the launches its capture recorded, which
    `hold_graphs_to_their_kernels` holds to the graph's kernel nodes."""
    pk.reset_launch_counts()
    out, ms = once_ms(fn)
    counts = dict(pk.launches)
    for kname in must:
        check(counts[kname] > 0, f"{label}: kernel {kname} was not launched")
    for kname in must_not:
        check(counts[kname] == 0, f"{label}: kernel {kname} was launched {counts[kname]} times")
    for kname in BATCH_KERNELS if batches else ():
        check(counts[kname] == batches,
              f"{label}: kernel {kname} was launched {counts[kname]} times for {batches} batches")
    if conversions is not None:
        check(counts["to_niels_xy_rows"] == conversions,
              f"{label}: to_niels_xy_rows launched {counts['to_niels_xy_rows']} times, "
              f"not once a base batch ({conversions})")
    return out, ms, counts


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from webgpu_msm_tpu_torch import MSMConfig, MSMPlan, api, benchmark, compute_msm, compute_msm_batch
    from webgpu_msm_tpu_torch.config import SUPPORTED_WINDOW_SIZES
    from webgpu_msm_tpu_torch.engines import baseline_engine, cpu_engine, gpu_engine, naive_engine
    from webgpu_msm_tpu_torch.ops import field_ops, limbs, pippenger
    from webgpu_msm_tpu_torch.ops.kernels import build
    from webgpu_msm_tpu_torch.runtime import build as native_build
    from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
    from webgpu_msm_tpu_torch.oracle import curve as ocurve
    from webgpu_msm_tpu_torch.oracle.msm import combine_windows
    from webgpu_msm_tpu_torch.oracle.pinned_vectors import PINNED
    from webgpu_msm_tpu_torch.parallel import (ShardedFixedBasePlan, default_mesh, distributed,
                                               msm_window_sums_sharded, scaling)
    from webgpu_msm_tpu_torch.parallel.msm_sharded import window_sums_affine
    from webgpu_msm_tpu_torch.utils import cache as stage_graphs
    from webgpu_msm_tpu_torch.utils import convert, fixtures, trace
    from webgpu_msm_tpu_torch.utils.interop import affine_from_planes

    dev = torch.device("cuda")
    # 1. device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # 2. build: the CUDA kernels with nvcc and, at the same time, the native
    # CPU engine with g++ (a missing g++ or OpenMP fails here)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        native = pool.submit(lambda: (native_build.load(), time.perf_counter() - t0)[1])
        build.load()
        print(f"build: {build.library_path().name} in {time.perf_counter() - t0:.1f} s")
        print(f"build: {native_build.library_path().name} (g++, OpenMP) in {native.result():.1f} s")
    occupancy = build.occupancy()
    for kname, line in sorted(build.ptxas_report().items()):
        occ = f"; occupancy {occupancy[kname]} warps an SM" if kname in occupancy else ""
        print(f"ptxas {kname}: {line}{occ}")

    # 3. the multiply rate, then each kernel against its plain version at the
    # main path's shapes
    ops_per_s = mad_rate_per_s(build)
    print(f"mad.lo.u32 rate: {ops_per_s / 1e12:.3f} T/s measured: the peak of the operations "
          f"bounds below [{smi}]")
    gen = torch.Generator().manual_seed(20)
    inputs = kernel_inputs(gen, dev)
    scan_mma = lambda p, i: pk.accumulate_scan(p, i, use_mma=True)
    scan_mma_plain = lambda p, i: pk.accumulate_scan_plain(p, i, use_mma=True)
    gather_mma = lambda *a: pk.accumulate_scan_gather(*a, use_mma=True)
    gather_mma_plain = lambda *a: pk.accumulate_scan_gather_plain(*a, use_mma=True)
    padd_py, padd_cu, mma_cu = PALLAS + "padd_kernels.py:{}", CSRC + "padd_kernels.cu", CSRC + "mma_kernels.cu"
    # name -> (wrapper, plain version, TPU kernel, source, timed launches)
    kernels = {
        # the planes kernel of the TPU contract, on no path since to_niels_xy_rows
        "to_niels_xy": (pk.to_niels_xy, pk.to_niels_xy_plain, padd_py.format(498), padd_cu, 20),
        "accumulate_scan": (pk.accumulate_scan, pk.accumulate_scan_plain, padd_py.format(258), padd_cu, 3),
        "padd_masked": (pk.padd_masked, pk.padd_masked_plain, padd_py.format(158), padd_cu, 20),
        "padd": (pk.padd, pk.padd_plain, padd_py.format(141), padd_cu, 20),
        "grouped_running_sum": (pk.grouped_running_sum, pk.grouped_running_sum_plain,
                                padd_py.format(391), padd_cu, 10),
        "to_niels": (pk.to_niels, pk.to_niels_plain, padd_py.format(493), padd_cu, 20),
        "accumulate_scan_mma": (scan_mma, scan_mma_plain, PALLAS + "field_kernels_mxu.py:125",
                                mma_cu, 3),
        "accumulate_scan_gather": (pk.accumulate_scan_gather, pk.accumulate_scan_gather_plain,
                                   padd_py.format(258), padd_cu, 3),
        "reduce_finish": (pk.reduce_finish, pk.reduce_finish_plain,
                          "webgpu_msm_tpu/ops/pippenger.py:441", padd_cu, 10),
        # padd_masked in the seg_level loop (webgpu_msm_tpu/ops/pippenger.py:328)
        "lane_scan": (pk.lane_scan, pk.lane_scan_plain, padd_py.format(158), padd_cu, 20),
        # padd in the bucket assembly (pippenger.py:385) and the engines' carry add
        "assemble_buckets": (pk.assemble_buckets, pk.assemble_buckets_plain, padd_py.format(141),
                             padd_cu, 20),
        # to_niels_xy with the BE unpack before it (tpu_engine.py:353, _wire_niels)
        # and the row packing after it, on every wire path
        "to_niels_xy_rows": (pk.to_niels_xy_rows, pk.to_niels_xy_rows_plain, padd_py.format(498),
                             padd_cu, 20),
        # the gathering scan with the tensor-core product, on no path
        "accumulate_scan_gather_mma": (gather_mma, gather_mma_plain, PALLAS + "field_kernels_mxu.py:125",
                                       mma_cu, 3),
        # not a Pallas kernel: the XLA tail of the JAX _finish_affine_impl (finv_mont,
        # two products, from_mont), with the divstep inverse, on the device_affine finish
        "finish_affine_divsteps": (pk.finish_affine_divsteps, pk.finish_affine_plain,
                                   "webgpu_msm_tpu/engines/tpu_engine.py:81", padd_cu, 20),
    }
    check(tuple(kernels) == pk.KERNELS, "the kernel table does not list the package's kernels")
    # Load each plain version's torch kernels once at a small shape, so its
    # timed call below does not pay for that.
    for kname, small in kernel_inputs(torch.Generator().manual_seed(0), dev, M=64, K=2, C=4,
                                      L=4, B=64, Gs=32).items():
        kernels[kname.split(" ")[0]][1](*small)
    rows = {}
    for kname, (kern, plain, replaces, source, reps) in kernels.items():
        args = inputs[kname]
        rows[kname] = hold(kname, kern, plain, args, reps, ops_per_s, replaces, source, smi)
        if kname == "grouped_running_sum":
            # The shape of the second reduction pass too: the main path runs
            # that pass inside reduce_finish, the kernel keeps the shape.
            a2 = inputs["grouped_running_sum pass 2"]
            check(max_abs_err(kern(*a2), plain(*a2)) == 0, f"{kname} pass 2 differs")
            b2, by2 = bound(kname, a2, ops_per_s)
            rows[kname].update(pass2_shape_ms=cuda_ms(lambda: kern(*a2), reps),
                               pass2_shape_bound_ms=b2, pass2_shape_launches=0)
            print(f"kernel {kname}: equal to plain on {tuple(a2[0].shape)} (a shape no path "
                  f"launches); {rows[kname]['pass2_shape_ms']:.4f} ms (bound {b2:.4f} ms by {by2}) "
                  f"[{smi}]")
        if kname == "padd_masked":
            # The naive engine's tree sum, the path that launches it: W =
            # pad_to of 2^16 points, b = a rolled by -d, mask lane + d < W,
            # every level in turn, each level's output the next one's input.
            levels = tree_sum_levels(gen, dev, 1 << 16, plain)
            for a, b, mask in levels:
                check(max_abs_err(kern(a, b, mask), plain(a, b, mask)) == 0,
                      f"{kname} differs at the tree sum's width (mask lane + {int((mask == 0).sum())} < W)")
            chain_ms = cuda_ms(lambda: [kern(*lv) for lv in levels], reps) / len(levels)
            chain_bound = sum(bound(kname, lv, ops_per_s)[0] for lv in levels) / len(levels)
            rows[kname].update(naive_shape_ms=chain_ms, naive_shape_bound_ms=chain_bound)
            print(f"kernel {kname}: equal to plain at the tree sum's {len(levels)} levels on "
                  f"{tuple(levels[0][0].shape)}; {chain_ms:.4f} ms a level (bound {chain_bound:.4f} ms "
                  f"a level) [{smi}]")
            del levels
        if kname == "finish_affine_divsteps":
            rows[kname].update(divstep_stats(args[0]))
            print(f"kernel {kname}: one thread a window, {rows[kname]['divstep_batches']} divstep batches in "
                  f"all ({rows[kname]['most_batches_a_window']} at most a window) and "
                  f"{FINISH_AFFINE_PRODUCTS} products a window, {rows[kname]['per_window_ops']} operations; its "
                  f"bound counts the least work, one divstep inverse by Montgomery's trick, "
                  f"{rows[kname]['least_work_ops']} operations, not their latency [{smi}]")
            rows[kname].update(wide_inverse_check(pk, gen, dev, smi))
        torch.cuda.empty_cache()
    scan_args = inputs["accumulate_scan"]
    del inputs

    # 3b. the device-resident path's kernels at its 2^20 shapes: w 16 signed
    # in one batch of C 2048 x L 512, so K 16 windows of B 32 800 buckets
    # (1 025 groups of Gs 32 a window), the top window's ids below
    # 2^13 + 1 (253-bit scalars), to_niels over W = 2^20, and the bucket
    # assembly adding into no carry (as `msm_window_sums` runs it)
    t0 = time.perf_counter()
    resident_inputs = kernel_inputs(gen, dev, M=1 << 20, K=16, C=2048, L=512, B=32800,
                                    top=(1 << 13) + 1, carry=False, names=RESIDENT_KERNELS)
    resident_rows = {}
    # the gathering scan's inputs: also the tensor-core gathering scan's
    # row below and the gathering pair of the A/B phase (4g)
    gather_args = resident_inputs["accumulate_scan_gather"]
    for kname in RESIDENT_KERNELS + ("accumulate_scan_gather_mma",):
        kern, plain, replaces, source, reps = kernels[kname]
        args = gather_args if kname == "accumulate_scan_gather_mma" else resident_inputs.pop(kname)
        resident_rows[kname] = hold(kname, kern, plain, args, reps, ops_per_s, replaces, source, smi,
                                    RESIDENT)
        torch.cuda.empty_cache()
    # the affine finish at the resident call's K 16 windows
    kern, plain, replaces, source, reps = kernels["finish_affine_divsteps"]
    mont16 = mont_sums(gen, 16).to(dev)
    resident_rows["finish_affine_divsteps"] = hold("finish_affine_divsteps", kern, plain, (mont16,), reps, ops_per_s,
                                                   replaces, source, smi, RESIDENT)
    resident_rows["finish_affine_divsteps"].update(divstep_stats(mont16))
    print(f"phase resident kernels: {time.perf_counter() - t0:.1f} s")

    # 4. the paths. Each is driven with the counts set to 0 just before and
    # read just after; launches made above do not count.
    graphs_checked = hold_graphs_to_their_kernels(stage_graphs, pk)
    cfg = MSMConfig()
    others = lambda *names: tuple(k for k in pk.KERNELS if k not in names)
    as_xy = lambda res: (res.x, res.y)
    # window sums on the card (plain domain) -> the affine MSM result
    affine_of = lambda out, w: ocurve.to_affine(combine_windows(
        gpu_engine.window_sums_to_points(out.cpu().numpy()), w))
    inputs = {}
    for power in sorted(PINNED):
        t0 = time.perf_counter()
        n = 1 << power
        points = fixtures.distinct_points_fast(n, seed=power)
        scalars = fixtures.random_scalars(n, seed=1000 + power)
        inputs[power] = (points, scalars, fixtures.wire_points(points),
                         convert.bigints_to_u32_be(scalars))
        print(f"inputs 2^{power}: regenerated in {time.perf_counter() - t0:.1f} s (host)")
    points, scalars, pts, sc = inputs[20]
    N = len(points)
    rate = lambda ms: f"{N / ms * 1e3:.0f} points/s"

    def n_batches(n: int) -> int:
        _, n_chunks, chunk_len = cfg.resolved_wire_plan(n)
        return -(-n // (n_chunks * chunk_len))

    # 4a. the wire path, at every pinned power
    for power in sorted(PINNED):
        _, _, pw, sw = inputs[power]
        wire = lambda: compute_msm(pw, sw, config=cfg, device=dev)
        res, cold_ms, counts = drive(f"wire 2^{power}", pk, wire, WIRE_KERNELS, others(*WIRE_KERNELS),
                                     n_batches(1 << power), n_batches(1 << power))
        check(as_xy(res) == PINNED[power], f"2^{power}: result differs from PINNED")
        print(f"compute_msm 2^{power}: equals PINNED[{power}]; launches {counts}")
        if power == 20:
            # padd_masked, padd and to_niels_xy: 0, on no compute_msm path
            # since lane_scan, assemble_buckets and to_niels_xy_rows
            for kname in WIRE_KERNELS + ("padd_masked", "padd", "to_niels_xy"):
                rows[kname]["launches"] = counts[kname]
            res, dispatch_ms, warm_ms, split = host_dispatch(api, gpu_engine, wire)
            check(as_xy(res) == PINNED[power], "2^20 warm call differs from PINNED")
            print(f"compute_msm 2^20 wall: cold {cold_ms / 1e3:.3f} s ({rate(cold_ms)}), "
                  f"warm {warm_ms / 1e3:.3f} s ({rate(warm_ms)}) [{smi}]")
            busy = profile_call("wire 2^20", wire, warm_ms)
            busy_ms, n_launches = busy if busy else (float("nan"), 0)
            print(f"compute_msm 2^20 warm: host dispatch {dispatch_ms:.1f} ms, wall {warm_ms:.1f} ms, "
                  f"device busy {busy_ms:.2f} ms, {n_launches} device launches [{smi}]")
            print("compute_msm 2^20 warm host dispatch by step: "
                  + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items()))
            print(f"compute_msm 2^20 stage graphs: {stage_graphs.stats()}")
            with stage_graphs.eager():
                res, dispatch_ms, warm_ms, split = host_dispatch(api, gpu_engine, wire)
                check(as_xy(res) == PINNED[power], "2^20 eager call differs from PINNED")
            print(f"compute_msm 2^20 eager (no graphs): host dispatch {dispatch_ms:.1f} ms, wall {warm_ms:.1f} "
                  "ms; by step: " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items()) + f" [{smi}]")
            w20 = cfg.resolved_wire_plan(N)[0]
            graph_ab("wire 2^20", stage_graphs, lambda: gpu_engine._dispatch_wire(pw, sw, cfg, dev)[0],
                     lambda out: check(affine_of(out, w20) == PINNED[20], "wire 2^20: differs from PINNED"), smi)
    for power in sorted(PINNED):  # the later phases run 2^16 and 2^20 only
        if power not in (16, 20):
            del inputs[power]

    # 4b. lists: the same input as lists of ExtPoints and ints, marshalled by
    # the API to wire rows, then the wire path's kernels
    t0 = time.perf_counter()
    api._job_rows(points, scalars)
    marshal_s = time.perf_counter() - t0
    res, ms, counts = drive("lists 2^20", pk, lambda: compute_msm(points, scalars, config=cfg, device=dev),
                            WIRE_KERNELS, others(*WIRE_KERNELS), n_batches(N))
    check(as_xy(res) == PINNED[20], "lists 2^20: result differs from PINNED")
    print(f"lists 2^20: equals PINNED[20]; launches {counts}")
    print(f"lists 2^20 wall: {ms / 1e3:.3f} s ({rate(ms)}), of which the host's marshal of "
          f"the lists to wire rows about {marshal_s:.3f} s (timed apart) [{smi}]")

    # 4d. the fixed-base plan: bases once, then three scalar jobs
    jobs = [sc] + [convert.bigints_to_u32_be(fixtures.random_scalars(N, seed=seed))
                   for seed in (2020, 3020)]
    with stage_graphs.eager():  # the references, without the graphs
        want = [PINNED[20]] + [as_xy(compute_msm(pts, s, config=cfg, device=dev)) for s in jobs[1:]]
    check(len(set(want)) == 3, "the three jobs' results are not distinct")
    plan, build_ms, counts = drive("plan build 2^20", pk, lambda: MSMPlan(pts, config=cfg, device=dev),
                                   ("to_niels_xy_rows",), others("to_niels_xy_rows"),
                                   conversions=n_batches(N))
    job_kernels = WIRE_KERNELS[1:]
    got, batch_ms, counts = drive("plan jobs 2^20", pk, lambda: plan.msm_batch(jobs),
                                  job_kernels, others(*job_kernels), len(jobs) * n_batches(N))
    check([as_xy(r) for r in got] == want, "plan jobs: results differ from PINNED / the wire path")
    res, one_ms = once_ms(lambda: plan.msm(jobs[1]))
    check(as_xy(res) == want[1], "plan.msm: result differs from the wire path")
    print(f"plan 2^20: job 0 equals PINNED[20], jobs 1 and 2 equal the wire path; "
          f"launches of 3 jobs {counts}")
    print(f"plan 2^20 wall: build {build_ms / 1e3:.3f} s; msm_batch of 3 jobs {batch_ms / 1e3:.3f} s "
          f"({batch_ms / 3e3:.3f} s a job, {rate(batch_ms / 3)}); one msm {one_ms / 1e3:.3f} s [{smi}]")
    profile_call("plan job 2^20", lambda: plan.msm(jobs[1]), one_ms, top=6)
    graph_ab("plan job 2^20", stage_graphs, lambda: plan._plan.dispatch(jobs[1])[0],
             lambda out: check(affine_of(out, plan._plan.w) == want[1], "plan job 2^20: differs"), smi)
    del plan
    # Three wire jobs queued before any is fetched: each finish's window sums
    # are cloned right after its replay, so each job returns its own result.
    got, ms, counts = drive("3 queued wire jobs 2^20", pk,
                            lambda: gpu_engine.msm_affine_batch_wire([(pts, s) for s in jobs], cfg, dev),
                            WIRE_KERNELS, others(*WIRE_KERNELS), len(jobs) * n_batches(N),
                            len(jobs) * n_batches(N))
    check(list(got) == want, "3 queued wire jobs 2^20: results differ from the eager calls'")
    print(f"3 queued wire jobs 2^20: each returns its own result (PINNED[20] and the eager calls'); "
          f"{ms / 1e3:.3f} s; launches {counts}; stage graphs {stage_graphs.stats()} [{smi}]")

    # 4e. compute_msm_batch at 2^16: shared bases (the plan branch), then
    # distinct arrays (the batched wire path)
    _, _, pw, sw = inputs[16]
    sw2 = convert.bigints_to_u32_be(fixtures.random_scalars(len(sw), seed=2016))
    want = [PINNED[16], as_xy(compute_msm(pw, sw2, config=cfg, device=dev))]
    for label, point_arrays, n_conversions in (("shared bases", [pw, pw], 1),
                                               ("distinct arrays", [pw, pw.copy()], 2)):
        got, ms, counts = drive(f"compute_msm_batch 2^16, {label}", pk,
                                lambda: compute_msm_batch(point_arrays, [sw, sw2], config=cfg, device=dev),
                                WIRE_KERNELS, others(*WIRE_KERNELS), 2 * n_batches(len(sw)),
                                n_conversions * n_batches(len(sw)))
        check([as_xy(r) for r in got] == want, f"compute_msm_batch ({label}): results differ")
        print(f"compute_msm_batch 2^16, {label}: 2 jobs equal PINNED[16] / the wire path in "
              f"{ms / 1e3:.3f} s; launches {counts} [{smi}]")

    # 4f. equal scalars at 2^16: every window is one bucket over all its
    # lanes, so every lane scan level adds; against the oracle's s * sum(P)
    points16, _, pw, _ = inputs[16]
    s_one = fixtures.random_scalars(1, seed=4016)[0]
    t0 = time.perf_counter()
    total = ocurve.IDENTITY
    for p in points16:
        total = ocurve.add(total, p)
    want = ocurve.to_affine(ocurve.scalar_mul(total, s_one))
    oracle_s = time.perf_counter() - t0
    same = convert.bigints_to_u32_be([s_one] * len(points16))
    res, ms, counts = drive("equal scalars 2^16", pk, lambda: compute_msm(pw, same, config=cfg, device=dev),
                            WIRE_KERNELS, others(*WIRE_KERNELS), n_batches(len(points16)),
                            n_batches(len(points16)))
    check(as_xy(res) == want, "equal scalars 2^16: result differs from the oracle's s * sum(P)")
    print(f"equal scalars 2^16: equals the oracle's s * sum(P) (oracle {oracle_s:.1f} s on the host); "
          f"{ms / 1e3:.3f} s; launches {counts} [{smi}]")

    # 4f'. a fixture round trip: a distinct-point case written in the
    # reference's text format, read back (its expected result recomputed by
    # the port's oracle at w 13), and the wire compute_msm on what was read
    t0 = time.perf_counter()
    case = fixtures.distinct_case(4096, seed=11)
    made_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        paths = (os.path.join(tmp, "points.txt"), os.path.join(tmp, "scalars.txt"))
        fixtures.save_test_case(case, *paths)
        t0 = time.perf_counter()
        loaded = fixtures.load_test_case(*paths)
        load_s = time.perf_counter() - t0
    check((loaded.points, loaded.scalars, loaded.expected) == (case.points, case.scalars, case.expected),
          "fixture round trip: the case read back differs from the case written")
    n_case = len(loaded.points)
    pw_case, sw_case = fixtures.wire_points(loaded.points), convert.bigints_to_u32_be(loaded.scalars)
    res, ms, counts = drive("fixture round trip 4096", pk, lambda: compute_msm(pw_case, sw_case, config=cfg, device=dev),
                            WIRE_KERNELS, others(*WIRE_KERNELS), n_batches(n_case), n_batches(n_case))
    check(as_xy(res) == case.expected, "fixture round trip: compute_msm differs from case.expected")
    print(f"fixture round trip: distinct_case(4096, seed=11) made in {made_s:.1f} s, written and read back "
          f"({load_s:.1f} s with the oracle's expected), compute_msm equals case.expected; {ms / 1e3:.3f} s; "
          f"launches {counts} [{smi}]")

    # 4g. the A/B path of the dense scans (the TPU kernel's contract, with
    # `staged`): no compute_msm path selects them; their entry point is this
    # comparison at the production shape, the CIOS scan and the tensor-core
    # scan in turns, required equal.
    def scan_ab():
        times = {False: [], True: []}
        outs = {}
        for use_mma in (False, True, True, False):
            times[use_mma].append(cuda_ms(lambda: pk.accumulate_scan(*scan_args, use_mma=use_mma), 3))
            outs[use_mma] = pk.accumulate_scan(*scan_args, use_mma=use_mma)
        check(max_abs_err(outs[False], outs[True]) == 0, "the tensor-core scan differs from the CIOS scan")
        return times

    ab_kernels = ("accumulate_scan", "accumulate_scan_mma")
    times, _, counts = drive("scan A/B", pk, scan_ab, ab_kernels, others(*ab_kernels))
    for kname in ab_kernels:  # the dense scans: on no compute_msm path since the gathering scan
        rows[kname]["launches"] = counts[kname]
    print(f"scan A/B {tuple(scan_args[0].shape)}: tensor-core scan equals CIOS scan on all outputs; "
          f"CIOS {min(times[False]):.4f} ms, tensor-core {min(times[True]):.4f} ms "
          f"(runs {times[False]} / {times[True]}); launches {counts}; "
          f"no compute_msm path launches either [{smi}]")
    del scan_args

    # The gathering pair at the resident shape: the CIOS and the tensor-core
    # gathering scans in turns, required equal on all three outputs.
    def gather_ab():
        times = {False: [], True: []}
        outs = {}
        for use_mma in (False, True, True, False):
            call = lambda: pk.accumulate_scan_gather(*gather_args, use_mma=use_mma)
            times[use_mma].append(cuda_ms(call, 3))
            outs[use_mma] = call()
        check(max_abs_err(outs[False], outs[True]) == 0,
              "the tensor-core gathering scan differs from the CIOS gathering scan")
        return times

    ab_kernels = ("accumulate_scan_gather", "accumulate_scan_gather_mma")
    times, _, counts = drive("gathering scan A/B", pk, gather_ab, ab_kernels, others(*ab_kernels))
    rows["accumulate_scan_gather_mma"]["launches"] = counts["accumulate_scan_gather_mma"]
    print(f"gathering scan A/B {tuple(gather_args[1].shape)} [resident 2^20]: tensor-core gathering scan "
          f"equals CIOS gathering scan on all outputs; CIOS {min(times[False]):.4f} ms, tensor-core "
          f"{min(times[True]):.4f} ms (runs {times[False]} / {times[True]}); launches "
          f"{ {k: v for k, v in counts.items() if v} }; no compute_msm path launches the tensor-core one "
          f"[{smi}]")
    del gather_args

    # 4h. the hybrid engine on the 2^20 wire input at cpu_work_ratio 0.2: the
    # native engine on the first int(0.2 n) rows in a worker thread while the
    # card computes the rest; the GPU share pads to the same four batches as
    # the whole input (the JAX rule, kept), the last one mostly identity rows
    hyb = MSMConfig(cpu_work_ratio=0.2)
    n_cpu = int(N * hyb.cpu_work_ratio)
    hybrid = lambda: compute_msm(pts, sc, config=hyb, device=dev)
    res, cold_ms, counts = drive("hybrid 0.2 wire 2^20", pk, hybrid, WIRE_KERNELS, others(*WIRE_KERNELS),
                                 n_batches(N - n_cpu), n_batches(N - n_cpu))
    check(as_xy(res) == PINNED[20], "hybrid 0.2 wire 2^20: result differs from PINNED")
    res, warm_ms = once_ms(hybrid)
    check(as_xy(res) == PINNED[20], "hybrid 0.2 wire 2^20 warm call differs from PINNED")
    w_native = hyb.resolved_window_size_native(N)
    threads = cpu_engine.resolved_threads(hyb, co_compute=True)
    cpu_part, cpu_ms = once_ms(lambda: cpu_engine.msm_wire(pts[:n_cpu], sc[:n_cpu], w_native, threads))
    gpu_part, gpu_ms = once_ms(lambda: gpu_engine.msm_affine_wire(pts[n_cpu:], sc[n_cpu:], hyb, dev))
    check(cpu_engine.add_affine(cpu_part, gpu_part) == PINNED[20], "hybrid shares: join differs from PINNED")
    w, C, L, pad_to = gpu_engine._padded_plan(hyb, N - n_cpu)
    print(f"hybrid 0.2 wire 2^20: equals PINNED[20]; launches {counts}")
    print(f"hybrid 0.2 wire 2^20: host os.cpu_count() {os.cpu_count()}, sched_getaffinity "
          f"{len(os.sched_getaffinity(0))}; CPU share {n_cpu} rows (w {w_native}, {threads} threads), "
          f"GPU share {N - n_cpu} rows padded to {pad_to} (w {w}, {pad_to // (C * L)} batches of {C * L}, "
          f"the last {1 - ((N - n_cpu) % (C * L)) / (C * L):.3f} identity rows)")
    print(f"hybrid 0.2 wire 2^20 wall: cold {cold_ms / 1e3:.3f} s, warm {warm_ms / 1e3:.3f} s; "
          f"CPU share alone {cpu_ms / 1e3:.3f} s, GPU share alone {gpu_ms / 1e3:.3f} s "
          f"[{smi}; host {os.cpu_count()} CPUs]")

    # 4i. the hybrid at cpu_work_ratio 1.0: the native engine alone, no kernel
    cpu_only = lambda: compute_msm(pts, sc, config=MSMConfig(cpu_work_ratio=1.0), device=dev, engine="hybrid")
    res, ms, counts = drive("hybrid 1.0 wire 2^20", pk, cpu_only, (), pk.KERNELS)
    check(as_xy(res) == PINNED[20], "hybrid 1.0 wire 2^20: result differs from PINNED")
    print(f"hybrid 1.0 (CPU only) wire 2^20: equals PINNED[20], no kernel launched; wall {ms / 1e3:.3f} s "
          f"(w {hyb.resolved_window_size_native(N)}, {cpu_engine.resolved_threads(hyb, False)} threads) "
          f"[host {os.cpu_count()} CPUs]")

    # 4j. the hybrid on lists at 2^16: marshalled to wire rows, then split
    points16, scalars16, pw16, sw16 = inputs[16]
    n16 = len(points16)
    n_gpu16 = n16 - int(n16 * hyb.cpu_work_ratio)
    res, ms, counts = drive("hybrid 0.2 lists 2^16", pk,
                            lambda: compute_msm(points16, scalars16, config=hyb, device=dev, engine="hybrid"),
                            WIRE_KERNELS, others(*WIRE_KERNELS), n_batches(n_gpu16))
    check(as_xy(res) == PINNED[16], "hybrid 0.2 lists 2^16: result differs from PINNED")
    print(f"hybrid 0.2 lists 2^16: equals PINNED[16]; {ms / 1e3:.3f} s; launches {counts} "
          f"[{smi}; host {os.cpu_count()} CPUs]")

    # 4k. the native CPU engine on lists at 2^16: no device, no kernel
    res, ms, counts = drive("cpu engine 2^16", pk, lambda: compute_msm(points16, scalars16, engine="cpu"),
                            (), pk.KERNELS)
    check(as_xy(res) == PINNED[16], "cpu engine 2^16: result differs from PINNED")
    print(f"engine cpu 2^16 (lists): equals PINNED[16], no kernel launched; {ms / 1e3:.3f} s "
          f"(w {cfg.resolved_window_size_native(n16)}, {cpu_engine.resolved_threads(cfg, False)} threads) "
          f"[host {os.cpu_count()} CPUs]")

    # 4m. the baseline at 2^16: host bucketing, the 16-bit ladder on the card
    # (plain PyTorch), host window sums and combine, each step timed apart
    steps = {"host bucketing": (baseline_engine, "_host_bucket_entries"),
             "host marshalling of the entries": (gpu_engine, "marshal_points"),
             "device ladder (synchronized)": (baseline_engine, "_device_mul_16bit"),
             "host unmarshalling of the products": (gpu_engine, "window_sums_to_points"),
             "host window sums and combine": (baseline_engine, "_combine")}
    with timed_steps(steps, sync=True) as spent:
        res, ms, counts = drive("baseline 2^16", pk,
                                lambda: compute_msm(points16, scalars16, device=dev, engine="baseline"),
                                (), pk.KERNELS)
    check(as_xy(res) == PINNED[16], "baseline 2^16: result differs from PINNED")
    print(f"baseline 2^16: equals PINNED[16], no kernel launched; wall {ms / 1e3:.3f} s; "
          f"{len(spent['device ladder (synchronized)'])} ladder chunks; by step: "
          + ", ".join(f"{k} {sum(t1 - t0 for t0, t1 in v):.3f} s" for k, v in spent.items())
          + f" [{smi}; host {os.cpu_count()} CPUs]")

    # 4n. routing at 2^16: a plan on another engine or with a split keeps no
    # resident bases and gives per-call results; so does compute_msm_batch
    want16 = [PINNED[16], as_xy(compute_msm(pw16, sw2, config=cfg, device=dev))]
    built = []
    real_plan = gpu_engine.WirePlan
    gpu_engine.WirePlan = lambda *a, **k: built.append(1) or real_plan(*a, **k)
    try:
        for label, plan_cfg, engine in (("MSMPlan engine hybrid", cfg, "hybrid"),
                                        ("MSMPlan cpu_work_ratio 0.2", hyb, None)):
            plan = MSMPlan(pw16, config=plan_cfg, device=dev, engine=engine)
            n_dev = n_gpu16 if plan_cfg.cpu_work_ratio else n16  # rows on the card a job
            got, ms, counts = drive(f"{label} 2^16", pk, lambda: plan.msm_batch([sw16, sw2]), WIRE_KERNELS,
                                    others(*WIRE_KERNELS), 2 * n_batches(n_dev), 2 * n_batches(n_dev))
            check(plan._plan is None and not built, f"{label}: a WirePlan was built")
            check([as_xy(r) for r in got] == want16, f"{label}: results differ from the wire calls'")
            print(f"routing: {label} 2^16 keeps no resident bases, 2 jobs equal PINNED[16] / the wire "
                  f"call in {ms / 1e3:.3f} s; launches {counts}")
        batch = lambda: compute_msm_batch([pw16, pw16], [sw16, sw2], config=hyb, device=dev)
        got, ms, counts = drive("compute_msm_batch ratio 0.2 2^16", pk, batch, WIRE_KERNELS,
                                others(*WIRE_KERNELS), 2 * n_batches(n_gpu16), 2 * n_batches(n_gpu16))
        per_call = [compute_msm(pw16, s, config=hyb, device=dev) for s in (sw16, sw2)]
        check(got == per_call and [as_xy(r) for r in got] == want16 and not built,
              "compute_msm_batch ratio 0.2: results differ from per-call compute_msm")
        print(f"routing: compute_msm_batch 2^16 at cpu_work_ratio 0.2 runs per call, equal to per-call "
              f"compute_msm and PINNED[16] / the wire call, in {ms / 1e3:.3f} s; launches {counts}")
    finally:
        gpu_engine.WirePlan = real_plan

    # 4o. the device-resident plan at 2^20: the pinned points and scalars as
    # plain digit planes and scalar words on the card before the clock,
    # `_device_msm` with the device-resident rules (one batch)
    t_resident = t0 = time.perf_counter()
    planes, words = gpu_engine.marshal_points(points, N), gpu_engine.marshal_scalars(scalars, N)
    marshal_s = time.perf_counter() - t0
    pts_t, sc_t = (torch.from_numpy(a.view(np.int32)).to(dev) for a in (planes, words))
    w_res, (C_res, L_res) = cfg.resolved_window_size(N), cfg.resolved_chunking(N)
    check((w_res, C_res, L_res) == (16, 2048, 512), f"resident rules at 2^20: {(w_res, C_res, L_res)}")
    signed = gpu_engine._signed_ok(cfg, words)
    print(f"resident 2^20: w {w_res}, C {C_res} x L {L_res} (resolved_window_size, resolved_chunking), "
          f"signed digits {signed}; marshalled on the host in {marshal_s:.1f} s, before the clock")
    resident = lambda: gpu_engine._device_msm(pts_t, sc_t, window_size=w_res, n_chunks=C_res,
                                              chunk_len=L_res, signed_digits=signed)
    out, cold_ms, counts = drive("resident 2^20", pk, resident, RESIDENT_KERNELS, others(*RESIDENT_KERNELS))
    check(all(counts[k] == 1 for k in RESIDENT_KERNELS), f"resident 2^20: launches {counts}, not one each")
    check(affine_of(out, w_res) == PINNED[20], "resident 2^20: result differs from PINNED")
    for kname in RESIDENT_KERNELS:
        resident_rows[kname]["launches"] = counts[kname]
    torch.cuda.reset_peak_memory_stats()
    out, warm_ms = once_ms(resident)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(affine_of(out, w_res) == PINNED[20], "resident 2^20 warm call differs from PINNED")
    out, queued_ms = queued_without_sync("resident 2^20", resident)
    check(affine_of(out, w_res) == PINNED[20], "resident 2^20 (sync check) differs from PINNED")
    busy = profile_call("resident 2^20", resident, warm_ms)
    busy_ms, n_launches = busy if busy else (float("nan"), 0)
    print(f"resident 2^20: equals PINNED[20]; launches {counts}; no synchronizing call before the finish")
    print(f"resident 2^20 wall: cold {cold_ms:.1f} ms, warm {warm_ms:.1f} ms ({rate(warm_ms)}); host queueing "
          f"{queued_ms:.1f} ms; device busy {busy_ms:.2f} ms, {n_launches} device launches; peak device "
          f"memory {peak_gb:.3f} GB [{smi}]")
    graph_ab("resident 2^20", stage_graphs, resident,
             lambda out: check(affine_of(out, w_res) == PINNED[20], "resident 2^20: differs from PINNED"), smi)
    # the resident call with the affine finish: finish_affine_divsteps once
    # more, at K 16; a replay of its finish graph and an eager call give the
    # same digits
    affine_kernels = RESIDENT_KERNELS + ("finish_affine_divsteps",)
    resident_affine = lambda: gpu_engine._device_msm(pts_t, sc_t, window_size=w_res, n_chunks=C_res,
                                                     chunk_len=L_res, signed_digits=signed, device_affine=True)
    out_affine, ms, counts = drive("resident device_affine 2^20", pk, resident_affine, affine_kernels,
                                   others(*affine_kernels))
    check(all(counts[k] == 1 for k in affine_kernels), f"resident device_affine 2^20: launches {counts}")
    check(tuple(out_affine.shape) == (2, 16, 16) and affine_of(out_affine, w_res) == PINNED[20],
          "resident device_affine 2^20: result differs from PINNED")
    resident_rows["finish_affine_divsteps"]["launches"] = counts["finish_affine_divsteps"]
    replays = stage_graphs.stats()["replays"]
    out_replayed = once_ms(resident_affine)[0]
    check(stage_graphs.stats()["replays"] > replays, "resident device_affine 2^20: the warm call replayed no graph")
    with stage_graphs.eager():
        out_eager = once_ms(resident_affine)[0]
    check(torch.equal(out_replayed, out_affine) and torch.equal(out_eager, out_affine),
          "resident device_affine 2^20: the graph and the eager outputs differ")
    print(f"resident device_affine 2^20: equals PINNED[20], a warm graph call and an eager call digit for digit; "
          f"launches { {k: v for k, v in counts.items() if v} }; {ms:.1f} ms (first call) [{smi}]")
    del out_affine, out_replayed, out_eager

    # What the affine finish adds to the resident call: the call with and
    # without device_affine in turns, warm, through the graphs, the least of
    # five walls a turn.
    walls = {"device_affine": [], "window sums": []}
    for label in ("device_affine", "window sums", "window sums", "device_affine") * AFFINE_TURNS:
        call = resident_affine if label == "device_affine" else resident
        walls[label].append(min(once_ms(call)[1] for _ in range(5)))
    q = {label: quartiles(v) for label, v in walls.items()}
    spread = lambda label: "/".join(f"{x:.3f}" for x in q[label])
    print(f"resident 2^20 with and without device_affine, in turns (warm walls through the graphs, quartiles of "
          f"{2 * AFFINE_TURNS} turns): device_affine {spread('device_affine')} ms, window sums "
          f"{spread('window sums')} ms; the finish adds {q['device_affine'][1] - q['window sums'][1]:.3f} ms at "
          f"the medians [{smi}]")
    resident_warm_ms = once_ms(resident)[1]  # the warm call, for the collective model (4p)
    # msm_window_sums on the Niels planes of the same points: one batch added
    # into no carry; its window sums equal the staged call's as points
    sums = lambda: pippenger.msm_window_sums(pk.to_niels(pts_t), sc_t, window_size=w_res, n_chunks=C_res,
                                             chunk_len=L_res, signed_digits=signed)
    mont, ms, counts = drive("msm_window_sums 2^20", pk, sums, RESIDENT_KERNELS, others(*RESIDENT_KERNELS))
    check(all(counts[k] == 1 for k in RESIDENT_KERNELS), f"msm_window_sums 2^20: launches {counts}")
    check(affine_from_planes(mont.cpu().numpy()) == affine_from_planes(out.cpu().numpy(), mont=False),
          "msm_window_sums 2^20: window sums differ from the staged call's as points")
    print(f"msm_window_sums 2^20: window sums equal the staged call's as points; {ms:.1f} ms; "
          f"launches {counts} [{smi}]")
    del out, mont
    print(f"phase resident: {time.perf_counter() - t_resident:.1f} s")

    # 4o''. a full MSM through the tensor-core gathering scan: the resident
    # plan's scan arguments for the same points and scalars, built as the
    # preamble of pippenger._accumulate_batch builds them (digits, the stable
    # sort, the lanes), then the scan with use_mma, lane_scan,
    # assemble_buckets, reduce_and_finish and the host combine
    def mma_msm():
        rows_r = pk.pack_rows(pk.to_niels(pts_t))
        digits = pippenger.compute_digits(limbs.as_i64(sc_t), w_res, signed)
        K, B = digits.shape[0], pippenger.n_buckets(w_res, signed)
        sorted_digits, perm = torch.sort(digits & 0x7FFFFFFF, dim=1, stable=True)
        sorted_packed = torch.gather(digits, 1, perm)
        lanes = lambda t: (limbs.as_i32(t).reshape(K, C_res, L_res).permute(2, 0, 1)
                           .reshape(L_res, K * C_res).contiguous())
        final_acc, final_id, partial = pk.accumulate_scan_gather(rows_r, lanes(perm), lanes(sorted_packed),
                                                                 K, B, use_mma=True)
        carries = pk.lane_scan(final_acc, final_id, K)
        buckets = torch.arange(B, device=dev).expand(K, B).contiguous()
        e_pos = torch.searchsorted(sorted_digits, buckets, right=True, out_int32=True)
        hist = torch.diff(e_pos, dim=1, prepend=torch.zeros((K, 1), dtype=torch.int32, device=dev))
        bs = pk.assemble_buckets(partial, carries, hist, e_pos, L_res).reshape(4, 16, K, B)
        return pippenger.reduce_and_finish(bs)[0]

    mma_kernels = ("to_niels", "accumulate_scan_gather_mma") + RESIDENT_KERNELS[2:]
    out, ms, counts = drive("tensor-core MSM 2^20", pk, mma_msm, mma_kernels, others(*mma_kernels))
    check(all(counts[k] == 1 for k in mma_kernels), f"tensor-core MSM 2^20: launches {counts}, not one each")
    check(affine_of(out, w_res) == PINNED[20], "tensor-core MSM 2^20: result differs from PINNED")
    resident_rows["accumulate_scan_gather_mma"]["launches"] = counts["accumulate_scan_gather_mma"]
    print(f"tensor-core MSM 2^20 (w {w_res} signed, C {C_res} x L {L_res}): equals PINNED[20] through "
          f"accumulate_scan_gather(use_mma=True); launches { {k: v for k, v in counts.items() if v} }; "
          f"wall {ms:.1f} ms (first call) [{smi}]")
    del out

    # 4o'. the bucket reduction at every group size, at the resident shape:
    # the same points' bucket sums after one accumulate_buckets (w 16 signed,
    # K 16, B 32 800), reduced at Gs 1 (the suffix scan, padd_masked once a
    # level on plain torch.rolls, then a plain from_mont) and at Gs 2-32
    # (grouped_running_sum, then reduce_finish with log2(Gs) doublings)
    t_reduce = time.perf_counter()
    bs = pippenger.accumulate_buckets(pk.to_niels(pts_t), limbs.as_i64(sc_t), window_size=w_res,
                                      n_chunks=C_res, chunk_len=L_res, signed_digits=signed)
    K_red, B_red = bs.shape[-2:]
    check((K_red, B_red) == (16, 32800), f"resident bucket sums: K {K_red}, B {B_red}")
    suffix_levels = (B_red - 1).bit_length()
    reduce_counts, reduce_walls, first_sums = {}, {}, None
    for Gs in REDUCE_GROUP_SIZES:
        want_counts = ({"padd_masked": 2 * suffix_levels} if Gs == 1
                       else {"grouped_running_sum": 1, "reduce_finish": 1})
        call = lambda: pippenger.reduce_and_finish(bs, group_size=Gs)
        (plain_ws, mont_ws), first_ms, counts = drive(f"reduce Gs {Gs} 2^20", pk, call, tuple(want_counts),
                                                      others(*want_counts))
        check(all(counts[k] == want_counts.get(k, 0) for k in pk.KERNELS),
              f"reduce Gs {Gs} 2^20: launches {counts}, not {want_counts}")
        sums = affine_from_planes(plain_ws.cpu().numpy(), mont=False)
        check(affine_from_planes(mont_ws.cpu().numpy()) == sums, f"reduce Gs {Gs}: the two outputs differ")
        first_sums = first_sums or sums
        check(sums == first_sums, f"reduce Gs {Gs}: window sums differ from Gs 1's as points")
        check(affine_of(plain_ws, w_res) == PINNED[20], f"reduce Gs {Gs} 2^20: result differs from PINNED")
        (plain_ws, _), warm_ms = once_ms(call)
        check(affine_of(plain_ws, w_res) == PINNED[20], f"reduce Gs {Gs} 2^20: warm result differs from PINNED")
        reduce_counts[Gs], reduce_walls[Gs] = counts, (first_ms, warm_ms)
        print(f"reduce Gs {Gs} 2^20: equals PINNED[20], window sums equal Gs 1's as points; launches "
              f"{ {k: v for k, v in counts.items() if v} }; wall first {first_ms:.3f} ms, warm {warm_ms:.3f} ms"
              + (" (the plain torch.rolls and from_mont included)" if Gs == 1 else "") + f" [{smi}]")
    # The Gs 1 path against the same levels on padd_masked's plain version.
    real_padd_masked = pk.padd_masked
    pk.padd_masked = pk.padd_masked_plain
    try:
        want_path, plain_path_ms = once_ms(lambda: pippenger._suffix_weighted(bs))
    finally:
        pk.padd_masked = real_padd_masked
    got_path, path_ms = once_ms(lambda: pippenger._suffix_weighted(bs))
    check(max_abs_err(got_path, want_path) == 0, "the suffix scan differs from its plain version")
    print(f"suffix scan 2^20 ({2 * suffix_levels} levels over {K_red * B_red} lanes): equal to its plain "
          f"version digit for digit; {path_ms:.3f} ms (plain {plain_path_ms:.1f} ms) [{smi}]")
    del got_path, want_path
    # padd_masked at the suffix scan's shape (level d 1), and the Gs 4 kernels.
    flat = bs.reshape(4, 16, -1)
    lane = torch.arange(B_red, device=dev).expand(K_red, B_red).reshape(-1)
    level1 = (flat, torch.roll(bs, -1, dims=-1).reshape(flat.shape), (lane + 1 < B_red).to(torch.int32))
    kern, plain, replaces, source, reps = kernels["padd_masked"]
    suffix_row = hold("padd_masked", kern, plain, level1, reps, ops_per_s, replaces, source, smi, SUFFIX)
    suffix_row["launches"] = reduce_counts[1]["padd_masked"]
    del level1, lane
    s4 = bs.reshape(4, 16, K_red * B_red // 4, 4).permute(3, 0, 1, 2).contiguous()
    gs4_rows = {}
    for kname, args in (("grouped_running_sum", lambda: (s4,)),
                        ("reduce_finish", lambda: (*pk.grouped_running_sum(s4), K_red, 2))):
        kern, plain, replaces, source, reps = kernels[kname]
        gs4_rows[kname] = hold(kname, kern, plain, args(), reps, ops_per_s, replaces, source, smi, GS4)
        gs4_rows[kname]["launches"] = reduce_counts[4][kname]
    del bs, flat, s4
    torch.cuda.empty_cache()
    print("reduce 2^20 walls by Gs (first, warm ms): "
          + ", ".join(f"Gs {g} {a:.3f}, {b:.3f}" for g, (a, b) in reduce_walls.items()) + f" [{smi}]")
    print(f"phase reduce: {time.perf_counter() - t_reduce:.1f} s")

    # 4p. the multi-GPU layer at 2^20 on the same points and scalars, w 16
    # signed (the resident rule): one NCCL rank (world size 1) and its
    # worker process, virtual meshes of D 2 and 4 shards on cuda:0 in both
    # collective modes, and the sharded fixed-base plan
    t_sharded = time.perf_counter()
    resident_s = resident_warm_ms / 1e3
    niels = pk.to_niels(pts_t)
    batch_count = lambda counts, D, reductions: (
        all(counts[k] == D for k in BATCH_KERNELS)
        and counts["grouped_running_sum"] == counts["reduce_finish"] == reductions
        and counts["padd_masked"] == (D - 1).bit_length())
    sharded_kernels = BATCH_KERNELS + ("grouped_running_sum", "reduce_finish")

    def sharded_call(label, call, D, reductions, sync_check=True):
        """Drive one sharded call: launch counts, PINNED[20], cold and warm
        wall, no sync before the result is read, busy time, launches, peak."""
        must = sharded_kernels + (("padd_masked",) if D > 1 else ())
        out, cold_ms, counts = drive(label, pk, call, must, others(*must))
        check(batch_count(counts, D, reductions), f"{label}: launches {counts}")
        check(window_sums_affine(out, w_res) == PINNED[20], f"{label}: result differs from PINNED")
        torch.cuda.reset_peak_memory_stats()
        out, warm = once_ms(call)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(window_sums_affine(out, w_res) == PINNED[20], f"{label}: warm result differs from PINNED")
        with stage_graphs.eager():
            check(torch.equal(call(), out), f"{label}: the graph call and the eager call differ")
        queued = float("nan")
        if sync_check:
            out, queued = queued_without_sync(label, call)
            check(window_sums_affine(out, w_res) == PINNED[20], f"{label} (sync check) differs from PINNED")
        busy = profile_call(label, call, warm, top=6)
        busy_ms, n_launches = busy if busy else (float("nan"), 0)
        print(f"{label}: equals PINNED[20]; launches {counts}"
              + ("; no synchronizing call before the result is read" if sync_check else ""))
        print(f"{label} wall: cold {cold_ms:.1f} ms, warm {warm:.1f} ms ({rate(warm)}); host queueing "
              f"{queued:.1f} ms; device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / warm:.3f}, "
              f"{n_launches} device launches; peak device memory {peak:.3f} GB [{smi}]")
        return counts

    # One NCCL rank over a local coordinator: the mesh of the world group,
    # one shard of C 2048 x L 512, its all-gather a collective of one rank.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # a single host: its loopback
    distributed.init(coordinator_address=f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
                     device=dev)
    mesh = distributed.global_mesh()
    check(mesh.group is not None and mesh.size == 1, f"world mesh: {mesh}")
    nccl = lambda: msm_window_sums_sharded(niels, sc_t, window_size=w_res, n_chunks=C_res, chunk_len=L_res,
                                           mesh=mesh, signed_digits=signed)
    sharded_out = lambda label: lambda out: check(window_sums_affine(out, w_res) == PINNED[20],
                                                  f"{label}: differs from PINNED")
    sharded_call("sharded NCCL world 1 2^20", nccl, 1, 1, sync_check=False)
    graph_ab("sharded NCCL world 1 2^20", stage_graphs, nccl, sharded_out("sharded NCCL world 1 2^20"), smi,
             sync_check=False)
    torch.distributed.destroy_process_group()
    worker = subprocess.run(
        [sys.executable, "-m", "webgpu_msm_tpu_torch.parallel._multihost_worker", "0", "1", str(free_port()),
         "--device", "cuda"], capture_output=True, text=True, timeout=300)
    check(worker.returncode == 0 and "MULTIHOST_OK process=0/1" in worker.stdout
          and " captures=0 " not in worker.stdout,
          f"_multihost_worker 0 1 on NCCL failed ({worker.returncode}):\n{worker.stdout[-3000:]}"
          f"\n{worker.stderr[-3000:]}")
    print("_multihost_worker 0 1 --device cuda: " + worker.stdout.strip().splitlines()[-1])

    # Virtual meshes: D shards of C 2048 x L 512 / D on cuda:0, both modes.
    for D in (2, 4):
        vmesh = default_mesh(D, device=dev)
        for mode in ("window_sums", "buckets"):
            call = lambda: msm_window_sums_sharded(niels, sc_t, window_size=w_res, n_chunks=C_res,
                                                   chunk_len=L_res // D, mesh=vmesh, mode=mode,
                                                   signed_digits=signed)
            label = f"sharded virtual D {D} {mode} 2^20"
            counts = sharded_call(label, call, D, D if mode == "window_sums" else 1)
            if D == 4:
                graph_ab(label, stage_graphs, call, sharded_out(label), smi)
            if (D, mode) == (4, "buckets"):
                tree_launches = counts["padd_masked"]
    del niels

    # The sharded fixed-base plan at D 4: the benchmark's repeated-base case
    # (the base point B, 2^20 times) placed once; two scalar jobs equal
    # sum(s) * B and launch neither to_niels nor pack_rows.
    pw_b, sw_b, want_b = benchmark._wire_case(N)
    _, sw_c, want_c = benchmark._wire_case(N, seed=100)
    planes_b = np.empty((3, 16, N), dtype=np.uint32)
    for k in range(3):  # x, y, t of the wire rows as plain digit planes
        coord = convert.be_rows_to_words_le(pw_b[:, 8 * k : 8 * k + 8])
        planes_b[k, 0::2], planes_b[k, 1::2] = coord & 0xFFFF, coord >> 16
    bases = pk.to_niels(torch.from_numpy(planes_b.view(np.int32)).to(dev))
    vmesh = default_mesh(4, device=dev)
    plan, build_ms = once_ms(lambda: ShardedFixedBasePlan(bases, window_size=w_res, n_chunks=C_res,
                                                          chunk_len=L_res // 4, mesh=vmesh,
                                                          signed_digits=True))
    del bases
    jobs = [(torch.from_numpy(convert.be_rows_to_words_le(s).view(np.int32)).to(dev), want)
            for s, want in ((sw_b, want_b), (sw_c, want_c))]
    packed = []
    real_pack = pippenger.pack_rows
    pippenger.pack_rows = lambda *a: packed.append(1) or real_pack(*a)
    try:
        got, jobs_ms, counts = drive("sharded plan D 4 jobs 2^20", pk,
                                     lambda: [window_sums_affine(plan.window_sums(w), w_res) for w, _ in jobs],
                                     sharded_kernels + ("padd_masked",),
                                     others(*sharded_kernels, "padd_masked"))
    finally:
        pippenger.pack_rows = real_pack
    check(got == [want for _, want in jobs], "sharded plan jobs: results differ from sum(s) * B")
    check(not packed and all(counts[k] == 8 for k in sharded_kernels) and counts["padd_masked"] == 4,
          f"sharded plan jobs: launches {counts} (2 jobs of 4 shards), pack_rows {len(packed)}")
    print(f"sharded plan D 4 2^20: build {build_ms:.1f} ms; 2 jobs equal sum(s) * B in {jobs_ms:.1f} ms "
          f"(the host's window combine included), no to_niels and no pack_rows; launches {counts} [{smi}]")
    job = lambda: plan.window_sums(jobs[1][0])
    torch.cuda.reset_peak_memory_stats()
    out, job_ms = once_ms(job)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(window_sums_affine(out, w_res) == jobs[1][1], "sharded plan job: result differs from sum(s) * B")
    with stage_graphs.eager():
        check(torch.equal(plan.window_sums(jobs[1][0]), out), "sharded plan job: the graph and eager calls differ")
    busy = profile_call("sharded plan D 4 job 2^20", job, job_ms, top=4)
    busy_ms, n_launches = busy if busy else (float("nan"), 0)
    print(f"sharded plan D 4 job 2^20 wall: warm {job_ms:.1f} ms; device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / job_ms:.3f}, {n_launches} device launches; peak device memory {peak:.3f} GB [{smi}]")
    del plan, jobs, out

    # The combine's kernel at the buckets-mode tree shape of D 4: [4, 16,
    # K * B * D] = [4, 16, 2 099 200] lanes, level d = 1 of the roll loop.
    K_res, B_res = 16, pippenger.n_buckets(w_res, True)
    a = field_planes(gen, (4,), K_res * B_res * 4).to(dev)
    b = torch.roll(a.reshape(4, 16, K_res, B_res, 4), -1, dims=-1).reshape(a.shape)
    lane = torch.arange(4, device=dev).expand(K_res, B_res, 4).reshape(-1)
    kern, plain, replaces, source, reps = kernels["padd_masked"]
    sharded_row = hold("padd_masked", kern, plain, (a, b, (lane + 1 < 4).to(torch.int32)), reps, ops_per_s,
                       replaces, source, smi, SHARDED)
    sharded_row["launches"] = tree_launches
    del a, b, lane
    torch.cuda.empty_cache()

    # The collective model against the resident call measured above, and the
    # virtual weak-scaling trend (2^18 points a shard).
    scaling.print_report(resident_s, device=dev, trend=dict(window_size=16, n_chunks=2048, chunk_len=128))
    del pts_t, sc_t
    print(f"phase sharded: {time.perf_counter() - t_sharded:.1f} s")

    # 4q. the window sweep at 2^20: the wire compute_msm on the benchmark's
    # repeated-base case at every supported w, signed and unsigned, with the
    # wire plan's batches; then the resident rule at w 13-17 signed on the
    # same inputs. Each call once for the launch counts and the result, then
    # timed warm; after each, the stage graphs must hold at most their limit.
    t_sweep = time.perf_counter()
    pw_b, sw_b, want_b = benchmark._wire_case(N)
    sweep = []
    stage_graphs.clear()
    graph_limit = stage_graphs.limit(dev)

    def within_limit(label: str) -> dict:
        held = stage_graphs.stats()
        check(held["bytes"] <= graph_limit, f"{label}: the stage graphs hold {held['bytes']} bytes, "
                                            f"past their limit {graph_limit}")
        return held
    for digits_signed in (True, False):
        for w in SUPPORTED_WINDOW_SIZES:
            c = MSMConfig(window_size=w, signed_digits=digits_signed)
            plan = c.resolved_wire_plan(N)
            batches = -(-N // (plan[1] * plan[2]))
            call = lambda: compute_msm(pw_b, sw_b, config=c, device=dev)
            torch.cuda.reset_peak_memory_stats()
            label = f"sweep w {w} {'signed' if digits_signed else 'unsigned'}"
            res, first_ms, _ = drive(label, pk, call, WIRE_KERNELS, others(*WIRE_KERNELS), batches, batches)
            check(as_xy(res) == want_b, f"{label}: result differs from sum(s) * B")
            res, ms = once_ms(call)
            check(as_xy(res) == want_b, f"{label}: warm result differs from sum(s) * B")
            held = within_limit(label)
            sweep.append({"w": w, "digits": "signed" if digits_signed else "unsigned", "wall_ms": ms,
                          "first_ms": first_ms, "plan": list(plan), "batches": batches,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "graphs_held": held["graphs"], "graph_gb": held["bytes"] / 1e9})
    planes_b = np.empty((3, 16, N), dtype=np.uint32)
    for k in range(3):  # x, y, t of the wire rows as plain digit planes
        coord = convert.be_rows_to_words_le(pw_b[:, 8 * k : 8 * k + 8])
        planes_b[k, 0::2], planes_b[k, 1::2] = coord & 0xFFFF, coord >> 16
    pts_t, sc_t = (torch.from_numpy(a.view(np.int32)).to(dev)
                   for a in (planes_b, convert.be_rows_to_words_le(sw_b)))
    resident_sweep = []
    for w in range(13, 18):
        call = lambda: gpu_engine._device_msm(pts_t, sc_t, window_size=w, n_chunks=C_res, chunk_len=L_res,
                                              signed_digits=True)
        out, first_ms = once_ms(call)
        check(affine_of(out, w) == want_b, f"resident rule w {w}: result differs from sum(s) * B")
        _, ms = once_ms(call)
        held = within_limit(f"resident rule w {w}")
        resident_sweep.append({"w": w, "digits": "signed", "ms": ms, "first_ms": first_ms,
                               "plan": [w, C_res, L_res], "graph_gb": held["bytes"] / 1e9})
    del pts_t, sc_t
    best = min(resident_sweep, key=lambda r: r["ms"])
    print(f"window sweep 2^20: all {len(sweep)} wire calls equal sum(s) * B; resident rule fastest at "
          f"w {best['w']} ({best['ms']:.1f} ms) [{smi}]")
    held = stage_graphs.stats()
    print(f"window sweep stage graphs, limit {graph_limit / 1e9:.3f} GB ({stage_graphs.MEMORY_SHARE} of the "
          f"card), held within it after every call: {held['captures']} captures, {held['evictions']} "
          f"evictions, {held['uncaptured']} first calls uncaptured, {held['graphs']} held at the end "
          f"({held['bytes'] / 1e9:.3f} GB), most held at once {held['peak_bytes'] / 1e9:.3f} GB (a new "
          f"graph before the limit dropped others); eager past half the limit: {held['too_large']}; peak "
          f"device memory of a sweep call {max(r['peak_gb'] for r in sweep):.3f} GB allocated [{smi}]")
    print(json.dumps({"window_sweep": sweep, "resident_sweep": resident_sweep, "card": smi}))
    print(f"phase window sweep: {time.perf_counter() - t_sweep:.1f} s")

    # 4r. the trace of one warm wire call: the JAX engine's phases, host clock
    # (one call first: the sweep may have dropped its stage graphs)
    check(as_xy(compute_msm(pts, sc, config=cfg, device=dev)) == PINNED[20], "wire call differs from PINNED")
    trace.reset()
    res = compute_msm(pts, sc, config=cfg, device=dev)
    check(as_xy(res) == PINNED[20], "traced wire call differs from PINNED")
    print("trace summary (warm wire 2^20; host clock, 'queue stages' is the queueing, 'fetch' the wait): "
          + "; ".join(" ".join(line.split()) for line in trace.summary().splitlines()))

    # 4s. device_affine: the wire call with the affine finish on the card, one
    # stage graph `finish_affine_w13_s1` through the finish_affine_divsteps
    # kernel; the plain finv_mont must not
    # run (it raises here)
    def no_plain_inverse(*_):
        raise RuntimeError("device_affine ran the plain finv_mont")

    real_finv, field_ops.finv_mont = field_ops.finv_mont, no_plain_inverse
    try:
        cfg_affine = MSMConfig(device_affine=True)
        affine = lambda: compute_msm(pts, sc, config=cfg_affine, device=dev)
        affine_kernels = WIRE_KERNELS + ("finish_affine_divsteps",)
        res, cold_ms, counts = drive("device_affine 2^20", pk, affine, affine_kernels, others(*affine_kernels),
                                     n_batches(N), n_batches(N))
        check(as_xy(res) == PINNED[20], "device_affine 2^20: result differs from PINNED")
        check(counts["finish_affine_divsteps"] == counts["reduce_finish"] == 1,
              f"device_affine 2^20: launches {counts}")
        rows["finish_affine_divsteps"]["launches"] = counts["finish_affine_divsteps"]
        res, warm_ms = once_ms(affine)
        check(as_xy(res) == PINNED[20], "device_affine 2^20 warm call differs from PINNED")
        print(f"device_affine 2^20: equals PINNED[20]; launches {counts}; no plain finv_mont")
        print(f"device_affine 2^20 wall: cold {cold_ms / 1e3:.3f} s ({rate(cold_ms)}), "
              f"warm {warm_ms / 1e3:.3f} s ({rate(warm_ms)}) [{smi}]")
        report = graph_ab("device_affine 2^20", stage_graphs,
                          lambda: gpu_engine._dispatch_wire(pts, sc, cfg_affine, dev)[0],
                          lambda out: check(affine_of(out, w20) == PINNED[20], "device_affine 2^20: differs"), smi)
        finish_key = f"finish_affine_w{w20}_s1"
        check(any(k[0] == finish_key for k in stage_graphs.CACHE._graphs),
              f"device_affine 2^20: no {finish_key} graph among {stage_graphs.stats()}")
        for mode in ("graphs", "eager"):
            check(report[mode]["device_launches"] < 2000,
                  f"device_affine 2^20 ({mode}): {report[mode]['device_launches']} device launches")
    finally:
        field_ops.finv_mont = real_finv

    # 4t. the naive engine at 2^16: a 256-step ladder in plain PyTorch on the
    # card, then the tree sum, one padd_masked launch a level
    pad16 = max(-(-n16 // 128) * 128, 128)
    levels16 = (pad16 - 1).bit_length()
    res, naive_ms, counts = drive("naive 2^16", pk,
                                  lambda: compute_msm(points16, scalars16, device=dev, engine="naive"),
                                  ("padd_masked",), others("padd_masked"))
    check(as_xy(res) == PINNED[16], "naive 2^16: result differs from PINNED")
    check(counts["padd_masked"] == levels16,
          f"naive 2^16: padd_masked launched {counts['padd_masked']} times, not {levels16}")
    rows["padd_masked"]["launches"] = counts["padd_masked"]
    naive_launches = naive_device_launches(naive_engine, gpu_engine, points16, scalars16, pad16, dev)
    print(f"naive 2^16: equals PINNED[16]; padd_masked {counts['padd_masked']} launches "
          f"((pad_to - 1).bit_length() for pad_to {pad16}), no other kernel; wall {naive_ms / 1e3:.3f} s, "
          f"{naive_launches} device launches (profiler counts of one and two ladder steps, extrapolated "
          f"to {naive_engine.SCALAR_BITS}) [{smi}]")

    # 5. summary lines
    check(graphs_checked, "no stage graph was captured")
    print(f"stage graphs: {len(graphs_checked)} captured, each one's kernel nodes (read from the graph by the "
          f"CUDA driver) equal to the launches its capture recorded; e.g. {graphs_checked[0]}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the builds included")
    print("kernels: " + ", ".join(pk.KERNELS) + "; at the resident shapes: "
          + ", ".join(resident_rows)
          + "; at the sharded tree's shape: padd_masked; at the suffix scan's shape: padd_masked; "
          + "at Gs 4: " + ", ".join(gs4_rows))
    print(json.dumps({"kernels": [rows[k] for k in pk.KERNELS]
                      + list(resident_rows.values()) + [sharded_row, suffix_row]
                      + list(gs4_rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
