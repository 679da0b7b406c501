// The bucket-accumulation scan with its Montgomery reductions on the tensor
// cores, for sm_90a.
//
// Replaces accumulate_scan(use_mxu=True) of the JAX package's
// ops/pallas/padd_kernels.py (_accumulate_scan_kernel with mul =
// kmont_mul_mxu, ops/pallas/field_kernels_mxu.py): the same scan as
// accumulate_scan_kernel (padd_kernels.cu), same inputs, same three outputs,
// digit for digit, but every Montgomery product reduces through two
// constant-matrix products instead of eight serial CIOS rounds:
//
//     T  = a * b                              (16 limbs, in registers)
//     m  = (T mod 2^256) * N0' mod 2^256      m_cols  = M1 @ bytes(T_lo)
//     mp = m * p                              mp_cols = M2 @ bytes(m)
//     r  = (T + mp) / 2^256, minus p if r >= p
//
// Which form. The TPU kernel forms T as 33 lazy 16-bit Comba columns and
// multiplies float32 byte planes, three per column, by M1 [32, 48], because
// its matrix unit has no exact integer path. This card has one:
// mma.sync.m16n8k32 on u8 operands with s32 accumulation. So T is formed
// here in 8 x 32-bit limbs with carries (64-bit multiply-adds), the low
// half's 32 true bytes are the operand, and M1 is [32, 32]; M2 is the TPU
// kernel's [64, 32]. R = 2^256 in both forms, so the residues are equal. A
// dot product of 32 byte pairs is below 2^21: the s32 sums are exact.
//
// Crossing threads. One thread owns one lane's field elements, but an mma
// fragment spreads a lane's bytes over four threads and returns a lane's
// result columns to four others. Each warp therefore has a tile of shared
// memory: every thread writes its 8 limbs (the 32 bytes, little-endian) to
// row `lane` of tile.b, the B fragments are read from there (thread (g, t)
// of the warp holds, for lane 8j + g, limbs t and 4 + t: bytes 4t..4t+3 and
// 16+4t..16+4t+3), the s32 results go to tile.o[column][lane], and every
// thread reads its own lane's columns back. That is two crossings a
// product; __syncwarp orders them. Row strides (9 and 40 words) keep the
// accesses clear of most bank conflicts.
//
// All 32 threads of a warp issue every mma: a lane beyond W computes on the
// last lane's data and only its stores are masked, and the run-boundary
// reset is a select, so no mma sits under a lane-dependent branch.
//
// m must be true bytes mod 2^256 between the two products; the 32 lazy
// columns are folded four at a time into 32-bit limbs with a 64-bit carry,
// 8 steps a lane. T + mp folds the same way over 16 limbs; its low half is
// zero by construction and only its carry is kept.
//
// Bound: that of accumulate_scan_kernel, the same work (the 1.34 GB staged
// write of a 2^18-point batch). The design aims only at being right; the
// products issue 24 mma a warp and 2 x 96 shared-memory words a lane beside
// the 64 multiply-adds of T.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace msm;

namespace {
constexpr int kMmaThreads = 64;  // two warps a block, as the CIOS scan
constexpr int kBStride = 9;      // words per lane in tile.b: 8 limbs + 1 pad
constexpr int kOStride = 40;     // words per column in tile.o: 32 lanes + 8 pad

// One warp's crossing tiles.
struct __align__(8) MmaTile {
  u32 b[32 * kBStride];
  int32_t o[64 * kOStride];
};

// D[16 x 8] = A[16 x 32] * B[32 x 8] on u8 operands, s32 sums, C = 0.
__device__ __forceinline__ void mma_u8(int32_t d[4], const u32 a[4], u32 b0, u32 b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// tile.o[c][lane] = sum_k mat[c][k] * byte_k(x of lane), c < 16 * MT, for all
// 32 lanes of the warp. mat is row-major u8 [16 * MT][32] in shared memory,
// read as 32-bit words, which are the A fragments as they stand.
template <int MT>
__device__ __forceinline__ void const_matrix_product(MmaTile& tile, const u32* mat,
                                                     const u32 x[8], int lane) {
#pragma unroll
  for (int i = 0; i < 8; i++) tile.b[lane * kBStride + i] = x[i];
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
  u32 b0[4], b1[4];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    b0[j] = tile.b[(8 * j + g) * kBStride + t];
    b1[j] = tile.b[(8 * j + g) * kBStride + 4 + t];
  }
#pragma unroll
  for (int i = 0; i < MT; i++) {
    const int r0 = 16 * i + g, r1 = r0 + 8;
    u32 a[4];
    a[0] = mat[r0 * 8 + t];      // row g,     bytes 4t..4t+3
    a[1] = mat[r1 * 8 + t];      // row g + 8
    a[2] = mat[r0 * 8 + 4 + t];  // row g,     bytes 16+4t..16+4t+3
    a[3] = mat[r1 * 8 + 4 + t];  // row g + 8
#pragma unroll
    for (int j = 0; j < 4; j++) {
      int32_t d[4];
      mma_u8(d, a, b0[j], b1[j]);
      // d0, d1: row r0, lanes 8j+2t and 8j+2t+1; d2, d3: row r1.
      *reinterpret_cast<int2*>(&tile.o[r0 * kOStride + 8 * j + 2 * t]) = make_int2(d[0], d[1]);
      *reinterpret_cast<int2*>(&tile.o[r1 * kOStride + 8 * j + 2 * t]) = make_int2(d[2], d[3]);
    }
  }
  __syncwarp();
}

// Four lazy byte columns 4k..4k+3 of this lane, weighted 2^0, 2^8, 2^16, 2^24.
__device__ __forceinline__ u64 column_word(const MmaTile& tile, int k, int lane) {
  u64 v = 0;
#pragma unroll
  for (int q = 0; q < 4; q++)
    v += (u64)(u32)tile.o[(4 * k + q) * kOStride + lane] << (8 * q);
  return v;
}

// t[0..15] = a * b, schoolbook with 64-bit multiply-adds.
__device__ __forceinline__ void mul_wide(u32 t[16], const u32 a[8], const u32 b[8]) {
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (u64)a[j] * b[i] + t[i + j];
      t[i + j] = (u32)c;
      c >>= 32;
    }
    t[i + 8] = (u32)c;
  }
}

// Montgomery product a*b*R^-1 mod p with the reduction on the tensor cores
// (kmont_mul_mxu). Same contract as mont_mul: a, b < p, result in [0, p).
// Every thread of the warp must call it together. r may alias a or b.
__device__ __forceinline__ void mont_mul_mma(u32 r[8], const u32 a[8], const u32 b[8],
                                             MmaTile& tile, const u32* m1, const u32* m2,
                                             int lane) {
  u32 t[16], m[8];
  mul_wide(t, a, b);
  const_matrix_product<2>(tile, m1, t, lane);  // bytes of T's low half -> 32 columns of m
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {  // true bytes of m mod 2^256: the carry past limb 7 drops
    c += column_word(tile, k, lane);
    m[k] = (u32)c;
    c >>= 32;
  }
  const_matrix_product<4>(tile, m2, m, lane);  // bytes of m -> 64 columns of m * p
  c = 0;
#pragma unroll
  for (int k = 0; k < 16; k++) {  // T + m*p: limbs 0..7 come out zero
    c += column_word(tile, k, lane) + t[k];
    t[k] = (u32)c;
    c >>= 32;
  }
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = t[8 + i];  // (T + m*p) / 2^256 < 2p < 2^254
  cond_sub_p(r);
}
}  // namespace

// ---------------------------------------------------------------------------
// accumulate_scan_mma. Inputs and outputs as accumulate_scan_kernel, plus
// m1 (row-major u8 [32][32]) and m2 (u8 [64][32]), the constant matrices
// built on the host (ops/kernels/field_kernels_mma.py), copied to shared
// memory once a block.
// ---------------------------------------------------------------------------
extern "C" __global__ void __launch_bounds__(kMmaThreads)
    accumulate_scan_mma_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ ids,
                               const u32* __restrict__ m1g, const u32* __restrict__ m2g,
                               int32_t* __restrict__ staged, int32_t* __restrict__ final_acc,
                               int32_t* __restrict__ final_id, int L, int W) {
  __shared__ u32 m1[32 * 8], m2[64 * 8];
  __shared__ MmaTile tiles[kMmaThreads / 32];
  for (int i = threadIdx.x; i < 32 * 8; i += kMmaThreads) m1[i] = m1g[i];
  for (int i = threadIdx.x; i < 64 * 8; i += kMmaThreads) m2[i] = m2g[i];
  __syncthreads();

  const int w0 = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = w0 < W;
  const int w = live ? w0 : W - 1;  // a lane beyond W shadows the last lane
  const int lane = threadIdx.x & 31;
  MmaTile& tile = tiles[threadIdx.x >> 5];
  const size_t LW = (size_t)L * W;
  Pt acc, ident;
  set_identity(acc);
  set_identity(ident);
  u32 acc_id = 0xffffffffu;
  for (int l = 0; l < L; l++) {
    const size_t at = (size_t)l * W + w;
    const u32 raw = (u32)ids[at];
    const u32 id = raw & 0x7fffffffu;
    u32 ym[8], yp[8], td[8];
    load_niels_signed(ym, yp, td, pts, LW, at, (raw >> 31) != 0);
    if (live) store_pt(staged, LW, at, acc);
    const bool same = id == acc_id;
#pragma unroll
    for (int q = 0; q < 8; q++) {
      acc.x[q] = same ? acc.x[q] : ident.x[q];
      acc.y[q] = same ? acc.y[q] : ident.y[q];
      acc.t[q] = same ? acc.t[q] : ident.t[q];
      acc.z[q] = same ? acc.z[q] : ident.z[q];
    }
    niels_add_with(acc, acc, ym, yp, td, [&](u32 o[8], const u32 a[8], const u32 b[8]) {
      mont_mul_mma(o, a, b, tile, m1, m2, lane);
    });
    acc_id = id;
  }
  if (live) {
    store_pt(final_acc, (size_t)W, w, acc);
    final_id[w] = (int32_t)acc_id;
  }
}

extern "C" int launch_accumulate_scan_mma(const void* pts, const void* ids, const void* m1,
                                          const void* m2, void* staged, void* final_acc,
                                          void* final_id, int L, int W, int device, void* stream) {
  if (const int err = use_device(device)) return err;
  const int grid = (W + kMmaThreads - 1) / kMmaThreads;
  accumulate_scan_mma_kernel<<<grid, kMmaThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pts, (const int32_t*)ids, (const u32*)m1, (const u32*)m2,
      (int32_t*)staged, (int32_t*)final_acc, (int32_t*)final_id, L, W);
  return (int)cudaGetLastError();
}
