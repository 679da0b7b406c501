// The point kernels of the MSM paths on CIOS Montgomery products, for sm_90a
// (the tensor-core REDC scan is in mma_kernels.cu).
//
// Each replaces one Pallas TPU kernel of the JAX package's
// ops/pallas/padd_kernels.py and keeps its tensor layouts, so the wrappers
// in ops/kernels/padd_kernels.py can hold each against its plain PyTorch
// version digit for digit. Every tensor is int32 holding u32 bits.
//
// The design is deliberately simple for now: one thread per lane, field
// elements in registers (field.cuh), no shared memory, no TMA, no wgmma.
// Thread w touches element w of every plane, so a warp's loads and stores
// are coalesced; the ragged last block is masked, so no width padding.
// Where a Pallas grid carried state in VMEM scratch from one step to the
// next, that state is a register loop inside one thread here.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace msm;

namespace {
constexpr int kThreads = 128;     // elementwise kernels
constexpr int kScanThreads = 64;  // long per-thread loops: more, smaller blocks

inline int blocks(int n, int threads) { return (n + threads - 1) / threads; }
}  // namespace

// ---------------------------------------------------------------------------
// to_niels_xy. Replaces _to_niels_xy_kernel (padd_kernels.py, to_niels_xy):
// plain (x, y) [2][16][M] -> Montgomery Niels (y-x, y+x, 2d*x*y) [3][16][M],
// with t = x*y formed in the kernel. Per lane: 4 Montgomery products, 128 B
// read and 192 B written; bound by bytes on the card.
// ---------------------------------------------------------------------------
extern "C" __global__ void to_niels_xy_kernel(const int32_t* __restrict__ in,
                                              int32_t* __restrict__ out, int M) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= M) return;
  const size_t stride = (size_t)M;
  u32 x[8], y[8], k[8], ym[8], yp[8], t[8];
  load_fp(x, in, stride, w);
  load_fp(y, in, stride, 16 * stride + w);
  load_const(k, R2_L);
  mont_mul(x, x, k);  // to_mont
  mont_mul(y, y, k);
  fsub(ym, y, x);
  fadd(yp, y, x);
  mont_mul(t, x, y);  // (x*y)R
  load_const(k, TWO_D_R_L);
  mont_mul(t, t, k);  // 2d*x*y*R
  store_fp(out, stride, w, ym);
  store_fp(out, stride, 16 * stride + w, yp);
  store_fp(out, stride, 32 * stride + w, t);
}

// ---------------------------------------------------------------------------
// to_niels. Replaces _to_niels_kernel (padd_kernels.py, to_niels): plain
// (x, y, t) [3][16][W] -> Montgomery Niels (y-x, y+x, 2d*t) [3][16][W], the
// planes path's conversion. x and y go to the Montgomery domain by R^2, and
// t by the one constant 2d*R^2: t * (2d*R^2) * R^-1 = 2d*t*R. Inputs must
// be below p, as for the TPU kernel. Per lane: 3 Montgomery products, 192 B
// read and 192 B written; bound by bytes on the card. One thread per lane,
// coalesced plane loads and stores, ragged last block masked.
// ---------------------------------------------------------------------------
extern "C" __global__ void to_niels_kernel(const int32_t* __restrict__ in,
                                           int32_t* __restrict__ out, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const size_t stride = (size_t)W;
  u32 x[8], y[8], t[8], k[8], ym[8], yp[8];
  load_fp(x, in, stride, w);
  load_fp(y, in, stride, 16 * stride + w);
  load_fp(t, in, stride, 32 * stride + w);
  load_const(k, R2_L);
  mont_mul(x, x, k);  // to_mont
  mont_mul(y, y, k);
  fsub(ym, y, x);
  fadd(yp, y, x);
  load_const(k, TWO_D_R2_L);
  mont_mul(t, t, k);  // 2d*t*R
  store_fp(out, stride, w, ym);
  store_fp(out, stride, 16 * stride + w, yp);
  store_fp(out, stride, 32 * stride + w, t);
}

// ---------------------------------------------------------------------------
// padd / padd_masked. Replace _padd_kernel and _padd_masked_kernel
// (padd_kernels.py, padd / padd_masked): out = a + b, or out = m ? a + b : a,
// over [4][16][W] point planes with the unified hwcd-3 add. Per lane: 9
// products, 512 B read (plus 4 B of mask) and 256 B written; bound by bytes.
// A lane whose mask is 0 copies a and skips the add.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void padd_lane(const int32_t* a, const int32_t* b,
                                          const int32_t* mask, int32_t* out, int W, int w) {
  Pt p, q;
  load_pt(p, a, (size_t)W, w);
  if (mask == nullptr || mask[w] != 0) {
    load_pt(q, b, (size_t)W, w);
    unified_add(p, p, q);
  }
  store_pt(out, (size_t)W, w, p);
}

extern "C" __global__ void padd_kernel(const int32_t* __restrict__ a,
                                       const int32_t* __restrict__ b,
                                       int32_t* __restrict__ out, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < W) padd_lane(a, b, nullptr, out, W, w);
}

extern "C" __global__ void padd_masked_kernel(const int32_t* __restrict__ a,
                                              const int32_t* __restrict__ b,
                                              const int32_t* __restrict__ mask,
                                              int32_t* __restrict__ out, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < W) padd_lane(a, b, mask, out, W, w);
}

// ---------------------------------------------------------------------------
// accumulate_scan. Replaces _accumulate_scan_kernel (padd_kernels.py,
// accumulate_scan): the fused bucket-accumulation scan. Lane w walks steps
// l = 0..L-1 of packed Niels points [3][8][L][W] (two 16-bit digits per
// word, i.e. one 32-bit limb) with bucket ids [L][W] (sign flag in bit 31):
//   1. unpack the limbs; 2. on the sign flag swap y-x with y+x and negate
//   2d*t; 3. write the accumulator as it was before this step to
//   staged[4][16][L][W]; 4. at a run boundary (id change; a sign change
//   does not split a run) reset it to the identity; 5. add with the 7-product
//   Niels add. The accumulator and its id (starting at the sentinel
//   0xFFFFFFFF) stay in registers for all L steps; final_acc [4][16][W] and
//   final_id [W] are written once.
// Per lane-step: 7 products, 100 B read, 256 B of staged written. At the
// 2^18-point batch (w = 13, L = 128, W = 40960) staged is 1.34 GB per launch
// and the launch does 36.7 M Montgomery products; the bound is the staged
// write, unless the products' issue rate binds first.
// ---------------------------------------------------------------------------
extern "C" __global__ void accumulate_scan_kernel(const int32_t* __restrict__ pts,
                                                  const int32_t* __restrict__ ids,
                                                  int32_t* __restrict__ staged,
                                                  int32_t* __restrict__ final_acc,
                                                  int32_t* __restrict__ final_id, int L,
                                                  int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const size_t LW = (size_t)L * W;
  Pt acc;
  set_identity(acc);
  u32 acc_id = 0xffffffffu;
  for (int l = 0; l < L; l++) {
    const size_t at = (size_t)l * W + w;
    const u32 raw = (u32)ids[at];
    const u32 id = raw & 0x7fffffffu;
    const bool neg = (raw >> 31) != 0;
    u32 ym[8], yp[8], td[8];
    load_niels_signed(ym, yp, td, pts, LW, at, neg);
    store_pt(staged, LW, at, acc);
    if (id != acc_id) set_identity(acc);
    niels_add(acc, acc, ym, yp, td);
    acc_id = id;
  }
  store_pt(final_acc, (size_t)W, w, acc);
  final_id[w] = (int32_t)acc_id;
}

// ---------------------------------------------------------------------------
// grouped_running_sum. Replaces _grouped_sum_kernel (padd_kernels.py,
// grouped_running_sum): over s [Gs][4][16][W], per lane, walk r = Gs-1..0
// with run += s[r] and, on every step but the last, U += run; then
// T = run = sum_r s[r] and U = sum_r r*s[r]. run and U stay in registers.
// Per lane: 2*Gs - 1 unified adds, 256*Gs B read and 512 B written; bound
// by the products (a few thousand lanes do not fill the card).
// ---------------------------------------------------------------------------
extern "C" __global__ void grouped_running_sum_kernel(const int32_t* __restrict__ s,
                                                      int32_t* __restrict__ T,
                                                      int32_t* __restrict__ U, int Gs,
                                                      int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  Pt run, u, sr;
  set_identity(run);
  set_identity(u);
  for (int i = 0; i < Gs; i++) {
    const int r = Gs - 1 - i;
    load_pt(sr, s + (size_t)r * 64 * W, (size_t)W, w);
    unified_add(run, run, sr);
    if (i != Gs - 1) unified_add(u, u, run);
  }
  store_pt(T, (size_t)W, w, run);
  store_pt(U, (size_t)W, w, u);
}

// ---------------------------------------------------------------------------
// Plain C entry points for ctypes: each launches on the given stream and
// returns cudaGetLastError() (0 on success). Sizes are positive.
// ---------------------------------------------------------------------------
extern "C" int launch_to_niels_xy(const void* in, void* out, int M, void* stream) {
  to_niels_xy_kernel<<<blocks(M, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, M);
  return (int)cudaGetLastError();
}

extern "C" int launch_to_niels(const void* in, void* out, int W, void* stream) {
  to_niels_kernel<<<blocks(W, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, W);
  return (int)cudaGetLastError();
}

extern "C" int launch_padd(const void* a, const void* b, void* out, int W, void* stream) {
  padd_kernel<<<blocks(W, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, W);
  return (int)cudaGetLastError();
}

extern "C" int launch_padd_masked(const void* a, const void* b, const void* mask, void* out,
                                  int W, void* stream) {
  padd_masked_kernel<<<blocks(W, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)mask, (int32_t*)out, W);
  return (int)cudaGetLastError();
}

extern "C" int launch_accumulate_scan(const void* pts, const void* ids, void* staged,
                                      void* final_acc, void* final_id, int L, int W,
                                      void* stream) {
  accumulate_scan_kernel<<<blocks(W, kScanThreads), kScanThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pts, (const int32_t*)ids, (int32_t*)staged, (int32_t*)final_acc,
      (int32_t*)final_id, L, W);
  return (int)cudaGetLastError();
}

extern "C" int launch_grouped_running_sum(const void* s, void* T, void* U, int Gs, int W,
                                          void* stream) {
  grouped_running_sum_kernel<<<blocks(W, kScanThreads), kScanThreads, 0,
                               (cudaStream_t)stream>>>((const int32_t*)s, (int32_t*)T,
                                                       (int32_t*)U, Gs, W);
  return (int)cudaGetLastError();
}

extern "C" const char* msm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
