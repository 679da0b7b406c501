// The point kernels of the MSM paths on CIOS Montgomery products, for sm_90a
// (the tensor-core REDC scan is in mma_kernels.cu).
//
// Each replaces one Pallas TPU kernel of the JAX package's
// ops/pallas/padd_kernels.py and keeps its tensor layouts, so the wrappers
// in ops/kernels/padd_kernels.py can hold each against its plain PyTorch
// version digit for digit. Every tensor is int32 holding u32 bits.
//
// The elementwise kernels and the dense scan are simple: one thread per
// lane, field elements in registers (field.cuh), thread w on element w of
// every plane, so a warp's loads and stores are coalesced; the ragged last
// block is masked, so no width padding. Where a Pallas grid carried state in
// VMEM scratch from one step to the next, that state is a register loop
// inside one thread here. The kernels the 2^20 call spent most on were
// designed again for this card: accumulate_scan_gather (four threads a lane,
// rows gathered in the kernel, bucket partial sums in place of the dense
// staged tensor), the tree reduction of grouped_running_sum (several
// threads a lane through shared memory), the end of the reduction
// (reduce_finish: a thread block cluster a window, four threads a point),
// the lane scan in one launch (lane_scan: a thread block cluster a window,
// in place of eleven padd_masked launches), the bucket assembly with the
// batch carry add (assemble_buckets, in place of two padd launches) and the
// wire input stage (to_niels_xy_rows: wire rows in, the scan's rows out).
// The affine finish replaces plain XLA ops, not a Pallas kernel:
// finish_affine_divsteps (a divstep inverse).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"
#include "gather_scan.cuh"

using namespace msm;
namespace cg = cooperative_groups;

namespace {
constexpr int kThreads = 128;     // elementwise kernels
constexpr int kScanThreads = 64;  // long per-thread loops: more, smaller blocks
constexpr int kGatherThreads = 256;  // the gathering scan: 64 lanes a block

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
// to_niels_xy_rows. The wire input stage of every batch: _to_niels_xy_kernel
// (padd_kernels.py, to_niels_xy) together with the unpack of the wire rows
// before it (tpu_engine.py, _wire_niels) and the packing of the rows that the
// scan gathers after it (pippenger.py, _accumulate_batch). In: wire x||y rows
// [M][16], x in words 0-7 and y in words 8-15, most significant word first.
// Out: packed Montgomery Niels rows [M][24], the LE limbs of y-x (words 0-7),
// y+x (8-15) and 2d*x*y (16-23), as accumulate_scan_gather reads them. The
// same 4 products in the same order as to_niels_xy_kernel, so the same
// digits, words >= p included. One thread a point reads its 64 B row with
// four 16-byte loads (a warp's 2 KB contiguous) and writes its 96 B row with
// six 16-byte stores: 160 B a point, where the planes kernel moved 320 and
// the unpack and packing passes around it moved more. Per point 4 CIOS
// products, 1 088 multiplies: the products, not the bytes, bound it.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store_limbs(int4* dst, const u32 a[8]) {
  dst[0] = make_int4((int)a[0], (int)a[1], (int)a[2], (int)a[3]);
  dst[1] = make_int4((int)a[4], (int)a[5], (int)a[6], (int)a[7]);
}

extern "C" __global__ void __launch_bounds__(kThreads)
to_niels_xy_rows_kernel(const int4* __restrict__ in, int4* __restrict__ out, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  u32 be[16];
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const int4 v = __ldg(in + (size_t)m * 4 + q);
    be[4 * q] = (u32)v.x;
    be[4 * q + 1] = (u32)v.y;
    be[4 * q + 2] = (u32)v.z;
    be[4 * q + 3] = (u32)v.w;
  }
  u32 x[8], y[8], k[8], ym[8], yp[8], t[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {  // BE words -> LE limbs
    x[i] = be[7 - i];
    y[i] = be[15 - i];
  }
  load_const(k, R2_L);
  mont_mul(x, x, k);  // to_mont
  mont_mul(y, y, k);
  fsub(ym, y, x);
  fadd(yp, y, x);
  mont_mul(t, x, y);  // (x*y)R
  load_const(k, TWO_D_R_L);
  mont_mul(t, t, k);  // 2d*x*y*R
  int4* dst = out + (size_t)m * 6;
  store_limbs(dst, ym);
  store_limbs(dst + 2, yp);
  store_limbs(dst + 4, t);
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
// lane_scan. The counterpart of the seg_level loop of the JAX package's
// _accumulate_batch (ops/pippenger.py), eleven padd_masked launches a batch
// at C = 2048, in one launch: the segmented inclusive scan over the C lanes
// of each window of in [4][16][K*C]. For d = 1, 2, 4, ... < C, lane c
// becomes v[c] + v[c-d] where c >= d and ids[c-d] == ids[c], and stays v[c]
// otherwise; every level reads the previous level's values, and the own
// value is the first operand, as in the JAX loop, so the digits are its
// digits. A window's lanes read only lanes of the same window, so window k
// is one thread block cluster of up to 8 blocks (cluster rank r takes lanes
// r * blockDim.x + tid, + 8 * blockDim.x, ...), and the cluster barrier
// separates the levels: no grid-wide sync, the 20 windows of a 2^20 batch
// run independently. The levels' values go through two ping-pong buffers in
// device memory (out and scratch, 5 MB each at W = 40960, resident in L2),
// loaded with ld.global.cg past the SM's L1, which another SM's stores do
// not update: one layout and one code path for every C (values in
// distributed shared memory would cap C at about 7 000 lanes on 8 blocks).
// A lane whose test fails copies its value and skips the add (the test is
// made at every level, so any ids give the JAX result; sorted ids make it
// fail for good once it fails). Bound: the bytes of in, ids and out, or the
// adds the masks imply, 9 products each. On random scalars only the top
// window adds much: its 65 buckets (w = 13) span about 31 lanes each, so its
// cluster adds in most lanes on five levels, and that cluster's chains of
// dependent products, one lane a thread on 8 SMs, set the time.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load_fp_l2(u32 r[8], const int32_t* src, size_t stride,
                                           size_t base) {
#pragma unroll
  for (int i = 0; i < 8; i++)
    r[i] = (u32)__ldcg(src + (2 * i) * stride + base) |
           ((u32)__ldcg(src + (2 * i + 1) * stride + base) << 16);
}

__device__ __forceinline__ void load_pt_l2(Pt& p, const int32_t* src, size_t stride,
                                           size_t base) {
  load_fp_l2(p.x, src, stride, base);
  load_fp_l2(p.y, src, stride, base + 16 * stride);
  load_fp_l2(p.t, src, stride, base + 32 * stride);
  load_fp_l2(p.z, src, stride, base + 48 * stride);
}

extern "C" __global__ void __launch_bounds__(256)
lane_scan_kernel(const int32_t* __restrict__ in, const int32_t* __restrict__ ids,
                 int32_t* out, int32_t* scratch, int K, int C, int levels) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const size_t W = (size_t)K * C, base = (size_t)(blockIdx.x / nb) * C;
  const int first = (int)cluster.block_rank() * blockDim.x + threadIdx.x;
  const int step = nb * blockDim.x;
  const int32_t* src = in;
  for (int i = 0; i < levels; i++) {
    const int d = 1 << i;
    // The last level writes out; the levels before it alternate.
    int32_t* dst = ((levels - 1 - i) & 1) ? scratch : out;
    for (int c = first; c < C; c += step) {
      const size_t w = base + c;
      Pt v;
      load_pt_l2(v, src, W, w);
      if (c >= d && __ldg(ids + w - d) == __ldg(ids + w)) {
        Pt u;
        load_pt_l2(u, src, W, w - d);
        unified_add(v, v, u);
      }
      store_pt(dst, W, w, v);
    }
    if (i + 1 < levels) cluster.sync();  // release this level's stores, acquire the others'
    src = dst;
  }
}

// ---------------------------------------------------------------------------
// assemble_buckets. The counterpart of the carry half of the JAX package's
// bucket assembly (ops/pippenger.py _accumulate_batch: carry_valid, c_last,
// the take, the where and _vadd(a_st, b_st)) and of the engines' batch carry
// add _vadd(carry, bucket sums), both over padd: three launches of plain
// index and select work and two padd launches a batch, in one. One thread a
// bucket t = k * B + b: from hist and e_pos (int32 [K][B]) it takes
// s = e - h, c_last = e / L - 1 and valid = c_last >= s / L, loads lane
// k * C + c_last of carries [4][16][K*C] (the lane scan's segment totals)
// where valid and the identity elsewhere, adds partial + picked, and, with a
// carry, carry + that sum: the JAX order, identities never skipped, so the
// digits are the JAX digits. out may be carry (each thread reads its bucket
// before it writes it). Per bucket 18 products and 4 points moved at most:
// bound by the products on the card. A thread's chain of 18 dependent
// products sets the time, so the launch must be one wave: at 2^20 (82 560
// buckets, 625 a SM) that takes 5 blocks of 128 an SM, so the registers are
// capped at 96 (142 uncapped, three blocks an SM and two waves; the cap
// spills about 200 bytes a thread to the L1 and is still 1.7x faster).
// ---------------------------------------------------------------------------
extern "C" __global__ void __launch_bounds__(kThreads, 5)
assemble_buckets_kernel(const int32_t* __restrict__ partial, const int32_t* __restrict__ carries,
                        const int32_t* __restrict__ hist, const int32_t* __restrict__ e_pos,
                        const int32_t* carry, int32_t* out, int K, int B, int C, int L) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= K * B) return;
  const size_t KB = (size_t)K * B;
  const int e = e_pos[t], s = e - hist[t], c_last = e / L - 1;
  Pt p, q;
  load_pt(p, partial, KB, t);
  if (c_last >= s / L)
    load_pt(q, carries, (size_t)K * C, (size_t)(t / B) * C + min(max(c_last, 0), C - 1));
  else
    set_identity(q);
  unified_add(p, p, q);
  if (carry != nullptr) {
    load_pt(q, carry, KB, t);
    unified_add(p, q, p);
  }
  store_pt(out, KB, t, p);
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
// accumulate_scan_gather. The counterpart of _accumulate_scan_kernel
// (padd_kernels.py, accumulate_scan) on every MSM path: the same scan, lane
// by lane and add by add, so final_acc and final_id are those of
// accumulate_scan digit for digit, but
//   - it gathers for itself: rows [M][24] holds each point's packed Niels
//     limbs (y-x, y+x, 2d*t; 96 B), perm [L][W] the row of lane w at step l.
//     A batch's rows are 25 MB and stay in the 50 MB L2 over the K re-reads;
//     no gathered [3][8][L][W] tensor is ever made;
//   - it writes only what is read: where the bucket id changes at a step
//     l > 0, the accumulator as it stood is the in-lane partial sum of bucket
//     acc_id and goes to partial [4][16][K][B] at (w / C, acc_id). The caller
//     fills partial with the identity; sorted ids give each bucket at most
//     one writer. That replaces staged [4][16][L][W], 1.34 GB a launch;
//   - four threads share a lane. On one thread a lane the card holds 310
//     threads an SM on one chain of 7 dependent products a step, and the
//     products' latency, not their issue rate, sets the time. Thread `role`
//     of a lane owns coordinate `role` of the accumulator (X, Y, T, Z). A
//     step is two rounds of one product a thread: A = (Y-X)*ym, B = (Y+X)*yp,
//     C = T*td and D = Z*2R (= 2Z), then, with A..D passed round by shuffle,
//     X = E*F, Y = G*H, T = E*H, Z = F*G. Each thread loads its own 32 B of
//     the row one step ahead, so the perm -> row latency is off the chain.
// Lanes beyond W shadow lane W-1, so that warps are whole for the shuffles,
// and store nothing. Per lane-step: 8 products, 104 B read; bound by the
// products. The body is gather_scan (gather_scan.cuh) on CIOS products; the
// tensor-core kernel (mma_kernels.cu) runs the same body.
// ---------------------------------------------------------------------------
extern "C" __global__ void __launch_bounds__(kGatherThreads)
accumulate_scan_gather_kernel(const int4* __restrict__ rows, const int32_t* __restrict__ perm,
                              const int32_t* __restrict__ ids, int32_t* __restrict__ partial,
                              int32_t* __restrict__ final_acc, int32_t* __restrict__ final_id,
                              int L, int W, int C, int B) {
  gather_scan(rows, perm, ids, partial, final_acc, final_id, L, W, C, B,
              [](u32 o[8], const u32 a[8], const u32 b[8]) { mont_mul(o, a, b); });
}

// ---------------------------------------------------------------------------
// tree_sums: T = sum_r s_r and U = sum_r r * s_r over one lane's Gs points,
// by P threads working together (P a power of two). The block holds
// LB = blockDim.x / P lanes side by side: thread tid is thread t = tid / LB
// of lane tid % LB, so neighbouring threads read neighbouring lanes.
// `elem(p, r)` gives element r of this thread's lane, the identity for
// r >= Gs. Thread t owns the q = ceil(Gs / P) elements from t * q on:
//   1. its chunk sum, q - 1 adds from the top element down;
//   2. an inclusive suffix scan of the chunk sums over the threads
//      (log2 P levels through shared memory): run at the chunk's first
//      element. T is thread 0's;
//   3. U's terms, run_r for every r >= 1 of the chunk: the scan's value
//      itself where q == 1, else a walk down the chunk from the next
//      thread's scan value;
//   4. a tree fold of the terms over the threads (log2 P levels).
// A chain of q - 1 + 2 * log2 P (+ 2q where q > 1) adds in place of the
// serial 2 * Gs - 1. Every add is done in this fixed order, padding
// included, and the plain version (_tree_sums in padd_kernels.py) adds in
// the same order: extended coordinates are not canonical, so only then are
// the digits equal. All threads of the block must call it; T and U are
// valid in the threads with t == 0. `sm` holds 32 words a thread.
// ---------------------------------------------------------------------------
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

template <class Elem>
__device__ __forceinline__ void tree_sums(Pt& T, Pt& U, Elem elem, int Gs, int P, u32* sm) {
  const int n = blockDim.x, tid = threadIdx.x, LB = n / P, t = tid / LB;
  const int q = (Gs + P - 1) / P;
  Pt x;
  elem(T, t * q + q - 1);
#pragma unroll 1
  for (int j = q - 2; j >= 0; j--) {
    elem(x, t * q + j);
    unified_add(T, x, T);
  }
#pragma unroll 1
  for (int d = 1; d < P; d <<= 1) {
    sm_put(sm, n, tid, T);
    __syncthreads();
    if (t + d < P) sm_get(x, sm, n, tid + d * LB);
    __syncthreads();
    if (t + d < P) unified_add(T, T, x);
  }
  if (q == 1) {
    U = T;
    if (t == 0) set_identity(U);
  } else {
    Pt run;
    sm_put(sm, n, tid, T);
    __syncthreads();
    if (t + 1 < P) sm_get(run, sm, n, tid + LB);
    else set_identity(run);
    __syncthreads();
#pragma unroll 1
    for (int j = q - 1; j >= 0; j--) {
      elem(x, t * q + j);
      unified_add(run, run, x);
      if (j == q - 1) U = run;
      else if (t * q + j > 0) unified_add(U, U, run);
    }
  }
#pragma unroll 1
  for (int h = P >> 1; h >= 1; h >>= 1) {
    sm_put(sm, n, tid, U);
    __syncthreads();
    if (t < h) sm_get(x, sm, n, tid + h * LB);
    __syncthreads();
    if (t < h) unified_add(U, U, x);
  }
}

// ---------------------------------------------------------------------------
// grouped_running_sum. Replaces _grouped_sum_kernel (padd_kernels.py,
// grouped_running_sum): over s [Gs][4][16][W], per lane, T = sum_r s[r] and
// U = sum_r r * s[r]. The TPU kernel walks r = Gs-1..0 in one running sum
// per lane; a few thousand lanes of 2 * Gs - 1 dependent adds leave this
// card idle, so P threads share a lane (tree_sums above). The wrapper picks
// P so that W * P threads about fill the card. Bytes are negligible
// (256 * Gs B read, 512 B written a lane); bound by the products.
// ---------------------------------------------------------------------------
extern "C" __global__ void __launch_bounds__(256)
grouped_running_sum_kernel(const int32_t* __restrict__ s, int32_t* __restrict__ T,
                           int32_t* __restrict__ U, int Gs, int W, int P) {
  extern __shared__ u32 sm[];
  const int LB = blockDim.x / P;
  const int w = blockIdx.x * LB + threadIdx.x % LB;
  const bool live = w < W;
  Pt t, u;
  tree_sums(
      t, u,
      [&](Pt& p, int r) {
        if (live && r < Gs) load_pt(p, s + (size_t)r * 64 * W, (size_t)W, w);
        else set_identity(p);
      },
      Gs, P, sm);
  if (live && threadIdx.x < LB) {
    store_pt(T, (size_t)W, w, t);
    store_pt(U, (size_t)W, w, u);
  }
}

// ---------------------------------------------------------------------------
// reduce_finish. Replaces the plain XLA ops that end the JAX package's
// reduce_buckets (ops/pippenger.py) after its second grouped_running_sum
// call, and the from_mont of the finish stage. Input: the first pass's T and
// U [4][16][K*G] (group g of window k at lane k * G + g). Output, per window,
// W = 2^d * sum_g g * T_g + sum_g U_g in the Montgomery and in the plain
// domain, [4][16][K] each.
//
// Bound: the latency of dependent point operations. One thread's unified
// add is a chain of about 14 500 cycles (8.5 us on an H100, as much with
// one warp an SM as with four: scripts/torch_reduce_probe.py), and a window
// holds a few thousand adds, so below Gs 4 the card's throughput never
// binds. The design shortens the chain and each of its links:
//   - a quad of four threads holds a point, thread `role` its coordinate
//     (X, Y, T, Z): an add is three rounds of one product a thread, a
//     doubling two (quad_add, quad_double), the operands passed by shuffle;
//   - window k is a thread block cluster of M blocks of NL lanes, N = M * NL
//     lanes, a power of two at most G (the wrapper's _finish_plan), on M SMs;
//   - lane n walks groups g = i * N + n for i = I - 1 .. 0 (I = ceil(G / N))
//     with two quads: one over T keeps s_n = sum_i T_g and r_n = sum_i i *
//     T_g (r += run for i >= 1), the other over U keeps u_n = sum_i U_g (two
//     links a group on the longer chain, not three). A warp reads
//     consecutive g, each T_g and U_g once. Then sum_g g * T_g = N * sum_n
//     r_n + sum_n n * s_n;
//   - a fold over n, lowest bit first, of four sums an element: rho' =
//     (rho_2p + rho_2p+1) + sigma_2p+1, sigma' = 2 (sigma_2p + sigma_2p+1),
//     tau' = 2 (tau_2p + tau_2p+1), ups' = ups_2p + ups_2p+1, from rho
//     empty, sigma = s, tau = r, ups = u. sum_n (rho_n + n sigma_n + tau_n)
//     keeps its value, so after log2 N levels rho + tau = sum_g g * T_g (tau
//     has gathered the factor N) and ups = sum_g U_g: two dependent adds a
//     level (a doubling is a unified add of a point with itself) and no
//     scalar multiple but doublings. The levels inside a block go through
//     shared memory with one barrier a level (an add takes thousands of
//     cycles, a barrier tens); then block 0 gathers the other blocks'
//     elements from their shared memory (distributed shared memory, two
//     cluster barriers) and runs the last log2 M levels;
//   - the tail in quad 0 of block 0: T* = rho + tau, d doublings, + ups, and
//     each thread's coordinate through from_mont: four products on four
//     threads.
// An empty value stands for the identity and is never added: an add with it
// is skipped, here and in the plain version alike (_fold_sums in
// padd_kernels.py adds in exactly this order; extended coordinates are not
// canonical, so only then are the digits equal). Shared memory marks it by
// limb 7 of z = 0xffffffff, which no value below p has. Quad operations and
// the branches around them are warp-uniform (__any_sync): the shuffles need
// every lane of the warp.
// ---------------------------------------------------------------------------
namespace {
constexpr u32 kFull = 0xffffffffu;
constexpr u32 kEmpty = 0xffffffffu;  // limb 7 of z in an empty slot
constexpr int kFinishThreads = 256;  // the most threads a block: 32 lanes of two quads
constexpr int kFoldOrder = 0x2031;   // fold items: sigma (1), ups (3), rho (0), tau (2)
}  // namespace

__device__ __forceinline__ void copy8(u32 r[8], const u32 a[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = a[i];
}

// The last round of an add or a doubling: X = E*F, Y = G*H, T = E*H, Z = F*G.
__device__ __forceinline__ void quad_out(u32 r[8], const u32 e[8], const u32 f[8], const u32 g[8],
                                         const u32 h[8], int role) {
  u32 lhs[8], rhs[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    lhs[i] = role == 1 ? g[i] : (role == 3 ? f[i] : e[i]);
    rhs[i] = role == 0 ? f[i] : (role == 3 ? g[i] : h[i]);
  }
  mont_mul(r, lhs, rhs);
}

// r = p + q (unified add-2008-hwcd-3) over a quad: each thread holds
// coordinate `role` of p and q and gets that of r. Every product is reduced
// below p, so A and B times Montgomery 1, D = Z1 Z2 times 2R and C = (T1 T2)
// times 2dR are unified_add's residues: its digits. r may alias p or q.
__device__ __forceinline__ void quad_add(u32 r[8], const u32 p[8], const u32 q[8], int role) {
  const int base = (threadIdx.x & 31) & ~3;
  u32 po[8], qo[8], u[8], v[8], w[8], k[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    po[i] = __shfl_xor_sync(kFull, p[i], 1);  // role 0 gets Y, role 1 gets X
    qo[i] = __shfl_xor_sync(kFull, q[i], 1);
  }
  u32 pd[8], ps[8], qd[8], qs[8];
  fsub(pd, po, p);  // role 0: Y1 - X1
  fadd(ps, p, po);  // role 1: Y1 + X1
  fsub(qd, qo, q);
  fadd(qs, q, qo);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u[i] = role == 0 ? pd[i] : (role == 1 ? ps[i] : p[i]);
    v[i] = role == 0 ? qd[i] : (role == 1 ? qs[i] : q[i]);
    k[i] = role == 2 ? TWO_D_R_L[i] : (role == 3 ? TWO_R_L[i] : R_L[i]);
  }
  mont_mul(w, u, v);
  mont_mul(w, w, k);  // A, B, C = 2d T1 T2, D = 2 Z1 Z2
  u32 a[8], b[8], c[8], d[8], e[8], f[8], g[8], h[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    a[i] = __shfl_sync(kFull, w[i], base);
    b[i] = __shfl_sync(kFull, w[i], base + 1);
    c[i] = __shfl_sync(kFull, w[i], base + 2);
    d[i] = __shfl_sync(kFull, w[i], base + 3);
  }
  fsub(e, b, a);
  fsub(f, d, c);
  fadd(g, d, c);
  fadd(h, b, a);
  quad_out(r, e, f, g, h, role);
}

// r = 2p (dbl-2008-hwcd, point_double's digits) over a quad: A = X^2,
// B = Y^2, (X + Y)^2 and Z^2 in one round, then the last. r may alias p.
__device__ __forceinline__ void quad_double(u32 r[8], const u32 p[8], int role) {
  const int base = (threadIdx.x & 31) & ~3;
  u32 x[8], y[8], u[8], w[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    x[i] = __shfl_sync(kFull, p[i], base);
    y[i] = __shfl_sync(kFull, p[i], base + 1);
  }
  fadd(u, x, y);
#pragma unroll
  for (int i = 0; i < 8; i++) u[i] = role == 2 ? u[i] : p[i];
  mont_mul(w, u, u);
  u32 a[8], b[8], c[8], d[8], e[8], f[8], g[8], h[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    a[i] = __shfl_sync(kFull, w[i], base);
    b[i] = __shfl_sync(kFull, w[i], base + 1);
    e[i] = __shfl_sync(kFull, w[i], base + 2);
    c[i] = __shfl_sync(kFull, w[i], base + 3);
  }
  fadd(c, c, c);
  fneg(d, a);
  fsub(h, d, b);
  fadd(e, e, h);
  fadd(g, d, b);
  fsub(f, g, c);
  quad_out(r, e, f, g, h, role);
}

// a <- a + b where both are points; the other one where one is empty; ae and
// be say which are. Every lane of the warp calls it.
__device__ __forceinline__ void quad_add_skip(u32 a[8], bool& ae, const u32 b[8], bool be,
                                              int role) {
  const bool both = !ae && !be;
  if (__any_sync(kFull, both)) {
    u32 s[8];
    quad_add(s, a, b, role);
    if (both) copy8(a, s);
  }
  if (ae && !be) copy8(a, b);
  ae = ae && be;
}

// A point slot of the block's shared memory: word w of slot j at sm[w * S + j]
// (x in words 0-7, y 8-15, t 16-23, z 24-31); thread `role` of a quad moves its
// coordinate. A negative slot is empty. Returns whether the slot is empty.
__device__ __forceinline__ bool quad_get(u32 v[8], const u32* sm, int S, int slot, int role) {
  if (slot < 0) return true;
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = sm[(8 * role + i) * S + slot];
  return sm[31 * S + slot] == kEmpty;
}

__device__ __forceinline__ void quad_put(u32* sm, int S, int slot, const u32 v[8], bool empty,
                                         int role) {
  if (!empty) {
#pragma unroll
    for (int i = 0; i < 8; i++) sm[(8 * role + i) * S + slot] = v[i];
  } else if (role == 3) {
    sm[31 * S + slot] = kEmpty;
  }
}

// The slot of sum q (0 rho, 1 sigma, 2 tau, 3 ups) of element e after fold
// level L, which leaves E elements in a block of NL lanes (S = 3 NL slots):
//   L 0, the walk's: sigma = s at e, tau = r at NL + e, ups = u at 2 NL + e,
//     rho empty;
//   L 1, in place in each pair's slots: rho at 2e + 1 (element 2e + 1's s,
//     unchanged), sigma 2e, tau NL + 2e, ups 2 NL + 2e;
//   odd L from 3 on: slot q E + e of the s slots;
//   even L from 2 on: entry q E + e of the odd r and u slots.
__device__ __forceinline__ int fold_slot(int L, int q, int e, int E, int NL) {
  if (L == 0) return q == 0 ? -1 : (q - 1) * NL + e;
  if (L == 1) return q == 0 ? 2 * e + 1 : (q - 1) * NL + 2 * e;
  const int j = q * E + e;
  if (L & 1) return j;
  return j < NL / 2 ? NL + 2 * j + 1 : 2 * NL + 2 * (j - NL / 2) + 1;
}

// Fold level L: element p < E from elements 2p and 2p + 1 of level L - 1.
// Item j < 4E takes sum (kFoldOrder >> 4 (j / E)) & 15 of element j % E, and
// the block's QB quads take the items in turn: at level 1 the rho items keep
// their slot and the tau items are empty unless a quad walked two groups, so
// sigma and ups come first. Each item reads only its own pair's slots of its
// own sum, so level 1 can write in place. Ends with a block barrier.
__device__ void fold_level(u32* sm, int NL, int L, int E, int quad, int QB, int role) {
  const int S = 3 * NL;
  for (int j0 = 0; j0 < 4 * E; j0 += QB) {
    const int j = j0 + quad;
    const bool live = j < 4 * E;
    if (!__any_sync(kFull, live)) continue;
    const int q = (kFoldOrder >> (4 * ((live ? j : 0) / E))) & 15, p = (live ? j : 0) % E;
    u32 a[8], b[8];
    bool ae = quad_get(a, sm, S, fold_slot(L - 1, q, 2 * p, 2 * E, NL), role) || !live;
    bool be = quad_get(b, sm, S, fold_slot(L - 1, q, 2 * p + 1, 2 * E, NL), role) || !live;
    quad_add_skip(a, ae, b, be, role);
    if (q == 0) {  // rho + sigma_2p+1
      be = quad_get(b, sm, S, fold_slot(L - 1, 1, 2 * p + 1, 2 * E, NL), role) || !live;
    } else {  // sigma and tau doubled; ups added once
      copy8(b, a);
      be = ae || q == 3;
    }
    quad_add_skip(a, ae, b, be, role);
    __syncwarp();
    if (live && !(L == 1 && q == 0)) quad_put(sm, S, fold_slot(L, q, p, E, NL), a, ae, role);
  }
  __syncthreads();
}

extern "C" __global__ void __launch_bounds__(kFinishThreads)
reduce_finish_kernel(const int32_t* __restrict__ T, const int32_t* __restrict__ U,
                     int32_t* __restrict__ out_plain, int32_t* __restrict__ out_mont, int G,
                     int K, int NL, int doublings) {
  extern __shared__ u32 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int M = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int k = blockIdx.x / M, S = 3 * NL, QB = blockDim.x >> 2;
  const int quad = threadIdx.x >> 2, role = threadIdx.x & 3;
  // Quads 0 .. NL - 1 walk T for lanes 0 .. NL - 1, the next NL walk U; a
  // block of one warp may hold quads beyond them.
  const bool over_t = quad < NL, own = quad < 2 * NL;
  const int lane = over_t ? quad : quad - NL;
  const int N = M * NL, n = rank * NL + lane, I = (G + N - 1) / N;
  const size_t stride = (size_t)K * G, at = (size_t)k * G + (size_t)16 * role * stride;
  const int32_t* src = over_t ? T : U;
  // run: s over T, u over U; r over T only.
  u32 run[8] = {}, r[8] = {}, x[8] = {};
  bool run_e = true, r_e = true;
#pragma unroll 1
  for (int i = I - 1; i >= 0; i--) {
    const int g = i * N + n;
    const bool valid = own && g < G;
    if (!__any_sync(kFull, valid)) continue;
    if (valid) load_fp(x, src, stride, at + g);
    quad_add_skip(run, run_e, x, !valid, role);
    if (i >= 1) quad_add_skip(r, r_e, run, run_e || !valid || !over_t, role);
  }
  if (over_t) {
    quad_put(sm, S, lane, run, run_e, role);
    quad_put(sm, S, NL + lane, r, r_e, role);
  } else if (own) {
    quad_put(sm, S, 2 * NL + lane, run, run_e, role);
  }
  __syncthreads();
  int L = 0;
  for (int E = NL >> 1; E >= 1; E >>= 1) fold_level(sm, NL, ++L, E, quad, QB, role);
  if (M > 1) {
    cluster.sync();  // every block's element is in its shared memory
    if (rank == 0 && quad < 4 * M) {  // quad j copies sum j / M of block j % M
      const int q = quad / M, b = quad % M;
      const u32* src = cluster.map_shared_rank(sm, b);
      const int from = fold_slot(L, q, 0, 1, NL), to = fold_slot(L + 1, q, b, M, NL);
#pragma unroll
      for (int i = 0; i < 8; i++) sm[(8 * role + i) * S + to] = src[(8 * role + i) * S + from];
    }
    cluster.sync();  // the copies are made: the other blocks may leave
    if (rank != 0) return;
    L++;
    for (int E = M >> 1; E >= 1; E >>= 1) fold_level(sm, NL, ++L, E, quad, QB, role);
  }
  if (threadIdx.x >= 32) return;
  // The tail in warp 0, whose quads all read element 0: W = 2^d (rho + tau) + ups.
  u32 w[8], v[8];
  bool we = quad_get(w, sm, S, fold_slot(L, 0, 0, 1, NL), role);
  bool ve = quad_get(v, sm, S, fold_slot(L, 2, 0, 1, NL), role);
  quad_add_skip(w, we, v, ve, role);  // sum_g g * T_g
  if (!we) {
#pragma unroll 1
    for (int i = 0; i < doublings; i++) quad_double(w, w, role);
  }
  ve = quad_get(v, sm, S, fold_slot(L, 3, 0, 1, NL), role);  // sum_g U_g
  quad_add_skip(w, we, v, ve, role);
  if (quad != 0) return;
  store_fp(out_mont + (size_t)16 * role * K, (size_t)K, k, w);
  const u32 one[8] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  mont_mul(w, w, one);  // from_mont
  store_fp(out_plain + (size_t)16 * role * K, (size_t)K, k, w);
}

// ---------------------------------------------------------------------------
// finish_affine_divsteps. Replaces the XLA tail of the JAX package's
// _finish_affine_impl (engines/tpu_engine.py): the z inverse (there
// field_ops.finv_mont, a Fermat chain of 386 dependent products), x * z^-1
// and y * z^-1, and from_mont. Input: the Montgomery window sums [4][16][K],
// as reduce_finish writes them; output: the plain affine (x, y) [2][16][K],
// z = 0 mapped to (0, 0) as finv_mont maps it; every residue reduced, so
// the digits equal the plain version's. The z inverse by Bernstein-Yang
// divsteps ("Fast constant-time gcd computation and modular inversion",
// CHES 2019) in the signed 30-bit form of libsecp256k1's modinv32.
//
// One thread a window. f, g, d and e are 9 signed limbs of 30 bits in
// registers, from f = p, g = z, d = 0, e = 1, so that d * z == f and
// e * z == g (mod p) throughout. A batch runs 30 branch-free divsteps on
// the low words of f and g (zeta = -(delta + 1/2), from delta = 1/2), which
// yield a matrix t with 2^30 * (f', g') = t * (f, g) and |u| + |v|,
// |q| + |r| <= 2^30; t is applied to f and g exactly and to d and e mod p
// (adding the multiple of p that clears their low 30 bits), each limb a
// 32x32->64 multiply-add. The loop ends once g == 0: about 17-18 batches for
// a random z, at most kDivstepMaxBatches. Then f = +-1, and d * sign(f),
// brought into [0, p), is the inverse of the residue zR, z^-1 R^-1; a
// product by R^2 makes it plain z^-1, and a product of the Montgomery x by
// that is plain x: three products, no from_mont. z = 0 runs no batch and
// leaves d = 0, so (0, 0), as finv_mont. Bound: the latency of the batches
// in one thread (about 20 threads a launch), not the card's throughput.
// ---------------------------------------------------------------------------
namespace {
constexpr int kDivstepBatch = 30;       // divsteps a batch: the limb width
constexpr int kDivstepMaxBatches = 25;  // ceil(733 / 30): CHES 2019's bound for 253 bits
constexpr int32_t kM30 = 0x3fffffff;
constexpr u32 kPInv30 = 1;  // p^-1 mod 2^30 (p = 1 mod 2^47)
}  // namespace

// p as 9 signed 30-bit limbs, least significant first.
static __constant__ int32_t P30[9] = {1,         675676160, 16,        714981300, 934281561,
                                      288651632, 173368843, 425174667, 4779};

// kDivstepBatch divsteps on the low words of f (odd) and g from zeta; the
// new zeta, and t = (u, v, q, r). The entries are kept as u32, which wraps
// as their two's complement; they lie in [-2^30, 2^30].
__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, u32 f, u32 g, int32_t t[4]) {
  u32 u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < kDivstepBatch; i++) {
    const u32 c1 = (u32)(zeta >> 31);  // zeta < 0
    const u32 c2 = 0u - (g & 1u);      // g odd
    g += ((f ^ c1) - c1) & c2;         // g - f (zeta < 0) or g + f, if g is odd
    q += ((u ^ c1) - c1) & c2;
    r += ((v ^ c1) - c1) & c2;
    const u32 c = c1 & c2;           // both: f takes the old g
    zeta = (zeta ^ (int32_t)c) - 1;  // -zeta - 2, else zeta - 1
    f += g & c;
    u += q & c;
    v += r & c;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return zeta;
}

// (f, g) <- t * (f, g) / 2^30, exact: the low 30 bits are zero.
__device__ __forceinline__ void update_fg_30(int32_t f[9], int32_t g[9], const int32_t t[4]) {
  int64_t cf = (int64_t)t[0] * f[0] + (int64_t)t[1] * g[0];
  int64_t cg = (int64_t)t[2] * f[0] + (int64_t)t[3] * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cf += (int64_t)t[0] * f[i] + (int64_t)t[1] * g[i];
    cg += (int64_t)t[2] * f[i] + (int64_t)t[3] * g[i];
    f[i - 1] = (int32_t)cf & kM30;
    g[i - 1] = (int32_t)cg & kM30;
    cf >>= 30;
    cg >>= 30;
  }
  f[8] = (int32_t)cf;
  g[8] = (int32_t)cg;
}

// (d, e) <- (t * (d, e) + p * (md, me)) / 2^30, md and me chosen so that
// the low 30 bits vanish; d and e in (-2p, p) stay there.
__device__ __forceinline__ void update_de_30(int32_t d[9], int32_t e[9], const int32_t t[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d[8] >> 31, se = e[8] >> 31;  // -1 where negative
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
  int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
  md -= (int32_t)((kPInv30 * (u32)cd + (u32)md) & (u32)kM30);
  me -= (int32_t)((kPInv30 * (u32)ce + (u32)me) & (u32)kM30);
  cd += (int64_t)P30[0] * md;
  ce += (int64_t)P30[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)P30[i] * md;
    ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)P30[i] * me;
    d[i - 1] = (int32_t)cd & kM30;
    e[i - 1] = (int32_t)ce & kM30;
    cd >>= 30;
    ce >>= 30;
  }
  d[8] = (int32_t)cd;
  e[8] = (int32_t)ce;
}

// d in (-2p, p) times the sign of `sign` (f's top limb), into [0, p), every
// limb in [0, 2^30).
__device__ __forceinline__ void normalize_30(int32_t d[9], int32_t sign) {
  int32_t add = d[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d[i] += P30[i] & add;  // (-p, p)
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d[i] = (d[i] ^ neg) - neg;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    d[i] += d[i - 1] >> 30;
    d[i - 1] &= kM30;
  }
  add = d[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d[i] += P30[i] & add;  // [0, p)
#pragma unroll
  for (int i = 1; i < 9; i++) {
    d[i] += d[i - 1] >> 30;
    d[i - 1] &= kM30;
  }
}

// 8 u32 limbs -> 9 limbs of 30 bits; and back, for a value below 2^256.
__device__ __forceinline__ void to_limbs30(int32_t r[9], const u32 a[8]) {
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int w = 30 * i / 32, s = 30 * i % 32;
    u32 x = a[w] >> s;
    if (s > 2 && w < 7) x |= a[w + 1] << (32 - s);
    r[i] = (int32_t)(x & (u32)kM30);
  }
}

__device__ __forceinline__ void from_limbs30(u32 r[8], const int32_t a[9]) {
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const int i = 32 * j / 30, s = 32 * j % 30;  // s <= 14: two limbs cover 32 bits
    r[j] = ((u32)a[i] >> s) | ((u32)a[i + 1] << (30 - s));
  }
}

extern "C" __global__ void __launch_bounds__(kThreads)
finish_affine_divsteps_kernel(const int32_t* __restrict__ mont, int32_t* __restrict__ out, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const size_t stride = (size_t)K;
  u32 z[8], zi[8], v[8];
  load_fp(z, mont, stride, 48 * stride + k);
  int32_t f[9], g[9], d[9], e[9], t[4];
#pragma unroll
  for (int i = 0; i < 9; i++) {
    f[i] = P30[i];
    d[i] = 0;
    e[i] = i == 0;
  }
  to_limbs30(g, z);
  int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
  for (int b = 0; b < kDivstepMaxBatches; b++) {
    int32_t nz = 0;
#pragma unroll
    for (int i = 0; i < 9; i++) nz |= g[i];
    if (nz == 0) break;
    zeta = divsteps_30(zeta, (u32)f[0], (u32)g[0], t);
    update_de_30(d, e, t);
    update_fg_30(f, g, t);
  }
  normalize_30(d, f[8]);
  from_limbs30(zi, d);  // (zR)^-1 = z^-1 R^-1
  load_const(v, R2_L);
  mont_mul(zi, zi, v);  // plain z^-1
#pragma unroll 1
  for (int c = 0; c < 2; c++) {  // x, then y: (X R) z^-1 R^-1 = x z^-1
    load_fp(v, mont, stride, 16 * c * stride + k);
    mont_mul(v, v, zi);
    store_fp(out, stride, 16 * c * stride + k, v);
  }
}

// ---------------------------------------------------------------------------
// Plain C entry points for ctypes: each makes `device` (the index of the
// tensors' card) current, launches on the given stream of that card and
// returns cudaGetLastError() (0 on success). Sizes are positive.
// ---------------------------------------------------------------------------
extern "C" int launch_to_niels_xy(const void* in, void* out, int M, int device, void* stream) {
  if (const int err = use_device(device)) return err;
  to_niels_xy_kernel<<<blocks(M, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, M);
  return (int)cudaGetLastError();
}

extern "C" int launch_to_niels_xy_rows(const void* in, void* out, int M, int device,
                                       void* stream) {
  if (const int err = use_device(device)) return err;
  to_niels_xy_rows_kernel<<<blocks(M, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)in, (int4*)out, M);
  return (int)cudaGetLastError();
}

extern "C" int launch_to_niels(const void* in, void* out, int W, int device, void* stream) {
  if (const int err = use_device(device)) return err;
  to_niels_kernel<<<blocks(W, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, W);
  return (int)cudaGetLastError();
}

extern "C" int launch_padd(const void* a, const void* b, void* out, int W, int device,
                           void* stream) {
  if (const int err = use_device(device)) return err;
  padd_kernel<<<blocks(W, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, W);
  return (int)cudaGetLastError();
}

extern "C" int launch_padd_masked(const void* a, const void* b, const void* mask, void* out,
                                  int W, int device, void* stream) {
  if (const int err = use_device(device)) return err;
  padd_masked_kernel<<<blocks(W, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)mask, (int32_t*)out, W);
  return (int)cudaGetLastError();
}

extern "C" int launch_lane_scan(const void* in, const void* ids, void* out, void* scratch,
                                int K, int C, int device, void* stream) {
  if (const int err = use_device(device)) return err;
  // A cluster of up to 8 blocks (the portable maximum) of up to 256 threads
  // a window; beyond 2048 lanes each thread takes several.
  const int threads = C < 256 ? (C + 31) / 32 * 32 : 256;
  const int per_window = blocks(C, threads) < 8 ? blocks(C, threads) : 8;
  int levels = 1;
  while ((1 << levels) < C) levels++;  // max(ceil(log2 C), 1)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * per_window);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = per_window;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, lane_scan_kernel, (const int32_t*)in,
                                             (const int32_t*)ids, (int32_t*)out,
                                             (int32_t*)scratch, K, C, levels);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int launch_assemble_buckets(const void* partial, const void* carries, const void* hist,
                                       const void* e_pos, const void* carry, void* out, int K,
                                       int B, int C, int L, int device, void* stream) {
  if (const int err = use_device(device)) return err;
  assemble_buckets_kernel<<<blocks(K * B, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)partial, (const int32_t*)carries, (const int32_t*)hist,
      (const int32_t*)e_pos, (const int32_t*)carry, (int32_t*)out, K, B, C, L);
  return (int)cudaGetLastError();
}

extern "C" int launch_accumulate_scan(const void* pts, const void* ids, void* staged,
                                      void* final_acc, void* final_id, int L, int W,
                                      int device, void* stream) {
  if (const int err = use_device(device)) return err;
  accumulate_scan_kernel<<<blocks(W, kScanThreads), kScanThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pts, (const int32_t*)ids, (int32_t*)staged, (int32_t*)final_acc,
      (int32_t*)final_id, L, W);
  return (int)cudaGetLastError();
}

extern "C" int launch_accumulate_scan_gather(const void* rows, const void* perm,
                                             const void* ids, void* partial, void* final_acc,
                                             void* final_id, int L, int W, int C, int B,
                                             int device, void* stream) {
  if (const int err = use_device(device)) return err;
  accumulate_scan_gather_kernel<<<blocks(4 * W, kGatherThreads), kGatherThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const int4*)rows, (const int32_t*)perm, (const int32_t*)ids, (int32_t*)partial,
      (int32_t*)final_acc, (int32_t*)final_id, L, W, C, B);
  return (int)cudaGetLastError();
}

extern "C" int occupancy_accumulate_scan_gather(int* warps) {
  return warps_per_sm(accumulate_scan_gather_kernel, kGatherThreads, warps);
}

extern "C" int launch_grouped_running_sum(const void* s, void* T, void* U, int Gs, int W,
                                          int P, int device, void* stream) {
  if (const int err = use_device(device)) return err;
  const int threads = P > kThreads ? P : kThreads, lanes = threads / P;
  grouped_running_sum_kernel<<<blocks(W, lanes), threads, 128 * threads,
                               (cudaStream_t)stream>>>((const int32_t*)s, (int32_t*)T,
                                                       (int32_t*)U, Gs, W, P);
  return (int)cudaGetLastError();
}

extern "C" int launch_reduce_finish(const void* T, const void* U, void* out_plain,
                                    void* out_mont, int G, int K, int M, int NL, int doublings,
                                    int device, void* stream) {
  if (const int err = use_device(device)) return err;
  // A cluster of M blocks a window (a power of two, at most 8), two quads a
  // lane, NL lanes a block (a power of two, at most 32); block 0 gathers
  // 4 M sums into NL slots with one quad each, so 4 M <= NL where M > 1.
  if (M < 1 || M > 8 || (M & (M - 1)) || NL < 1 || NL > 32 || (NL & (NL - 1)) ||
      (M > 1 && 4 * M > NL))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * M);
  cfg.blockDim = dim3(NL < 4 ? 32 : 8 * NL);
  cfg.dynamicSmemBytes = (size_t)3 * NL * 32 * sizeof(u32);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = M;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, reduce_finish_kernel, (const int32_t*)T,
                                             (const int32_t*)U, (int32_t*)out_plain,
                                             (int32_t*)out_mont, G, K, NL, doublings);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int launch_finish_affine_divsteps(const void* mont, void* out, int K, int device,
                                             void* stream) {
  if (const int err = use_device(device)) return err;
  finish_affine_divsteps_kernel<<<blocks(K, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)mont, (int32_t*)out, K);
  return (int)cudaGetLastError();
}

extern "C" const char* msm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
