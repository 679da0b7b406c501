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
//
// accumulate_scan_gather_mma_kernel (below) is the same reduction on the
// gathering scan's contract, the scan of every MSM path: its body is the
// CIOS gathering kernel's (gather_scan.cuh), so it writes no staged tensor
// and runs four threads a lane, one product a thread a round. A warp's
// round is then 32 products, which the quad product (mont_mul_mma_quad)
// keeps in registers: each lane's four products stay in its own quad of the
// mma tiles, and no tile of shared memory is needed.

#include <cuda_runtime.h>

#include "field.cuh"
#include "gather_scan.cuh"

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

// ---------------------------------------------------------------------------
// The quad product: the same reduction with the products on the M side of
// m16n8k32 and no shared memory, for the gathering scan, where quad g of a
// warp (threads 4g .. 4g + 3) is one lane and thread t of it holds role t's
// product. Role r is row g + 8 (r & 1) of m-tile r >> 1, so a warp's 32
// products are two m-tiles, and each n-tile of 8 result columns is one mma
// a m-tile.
//   A (the operand bytes): thread t holds, for rows g and g + 8, bytes
//     4t..4t+3 and 16+4t..16+4t+3, which are limbs t and 4 + t of two of
//     its quad's operands: a 4 x 4 transpose of limb pairs inside the quad,
//     three shuffles for each half (quad_fragments).
//   B (the constant): row-major M1 [32][32] and M2 [64][32] are B
//     fragments as they stand: words t and 4 + t of row 8j + g for n-tile
//     j, loaded once a thread into registers (QuadConsts).
//   D: thread t holds columns 8j + 2t and 8j + 2t + 1 of its quad's four
//     rows. The two are packed into one word (c0 + c1 << 8 < 2^30) and each
//     owner gathers its product's words from the other three threads: three
//     shuffles an n-tile (quad_matrix_product). Owner t's 32-bit limb 2j + e
//     is the word of thread 2e plus the word of thread 2e + 1 shifted by 16.
// Exchanges by xor: at step s thread t reads thread t ^ s, which sends what
// its reader needs; xperm4 orders a thread's four words by t ^ s with two
// layers of selects, before the send and after the receive.
//
// M2 runs on n-tiles 3..7 only (columns 24..63, 10 mma a warp; 8 for M1).
// With L = sum_{k<32} col_k 2^8k the low half of m*p, T_lo + L is a multiple
// q 2^256 (m*p = -T_lo mod 2^256), and L = A 2^192 + B with A the columns
// 24..31 and 0 <= B < 2^206. So q 2^256 is the one multiple of 2^256 in
// [X, X + 2^206) for X = T_lo + A 2^192: q = ceil(X / 2^256), which needs
// limbs 6 and 7 of T, whether limbs 0..5 are all zero, and A. Then
// (T + m*p) / 2^256 = T_hi + H + q, H the high columns. A product moves 39
// words through shuffles (6 + 12 for M1, 6 + 15 for M2), where the tile of
// mont_mul_mma moved 224 through shared memory, and needs no __syncwarp for
// its data.
// ---------------------------------------------------------------------------
constexpr unsigned kFull = 0xffffffffu;
constexpr int kM2Tile0 = 3;  // the first n-tile of M2 that the quad product computes

// w[x] = v[t ^ x] for x = 0..3, in registers.
__device__ __forceinline__ void xperm4(u32 w[4], const u32 v[4], int t) {
  const bool b0 = (t & 1) != 0, b1 = (t & 2) != 0;
  const u32 u0 = b0 ? v[1] : v[0], u1 = b0 ? v[0] : v[1];
  const u32 u2 = b0 ? v[3] : v[2], u3 = b0 ? v[2] : v[3];
  w[0] = b1 ? u2 : u0;
  w[1] = b1 ? u3 : u1;
  w[2] = b1 ? u0 : u2;
  w[3] = b1 ? u1 : u3;
}

// Thread (g, t)'s B fragments: words t and 4 + t of row 8j + g, for the
// n-tiles of M1 and for n-tiles kM2Tile0..7 of M2.
struct QuadConsts {
  u32 m1[4][2], m2[8 - kM2Tile0][2];
};

__device__ __forceinline__ void load_quad_consts(QuadConsts& k, const u32* __restrict__ m1,
                                                 const u32* __restrict__ m2, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    k.m1[j][0] = __ldg(m1 + (8 * j + g) * 8 + t);
    k.m1[j][1] = __ldg(m1 + (8 * j + g) * 8 + 4 + t);
  }
#pragma unroll
  for (int j = 0; j < 8 - kM2Tile0; j++) {
    k.m2[j][0] = __ldg(m2 + (8 * (kM2Tile0 + j) + g) * 8 + t);
    k.m2[j][1] = __ldg(m2 + (8 * (kM2Tile0 + j) + g) * 8 + 4 + t);
  }
}

// a[i]: thread t's A fragment of m-tile i, from the quad's four operands x
// (this thread's is role t's): limbs t of roles 2i and 2i + 1, then limbs
// 4 + t of the same two.
__device__ __forceinline__ void quad_fragments(u32 a[2][4], const u32 x[8], int t, int base) {
  u32 send_lo[4], send_hi[4], got_lo[4], got_hi[4], lo[4], hi[4];
  xperm4(send_lo, x, t);  // send_lo[s]: limb t ^ s, which thread t ^ s needs
  xperm4(send_hi, x + 4, t);
#pragma unroll
  for (int s = 0; s < 4; s++) {  // got_lo[s]: limb t of role t ^ s
    got_lo[s] = s ? __shfl_sync(kFull, send_lo[s], base + (t ^ s)) : send_lo[s];
    got_hi[s] = s ? __shfl_sync(kFull, send_hi[s], base + (t ^ s)) : send_hi[s];
  }
  xperm4(lo, got_lo, t);  // lo[r]: limb t of role r
  xperm4(hi, got_hi, t);
#pragma unroll
  for (int i = 0; i < 2; i++) {
    a[i][0] = lo[2 * i];
    a[i][1] = lo[2 * i + 1];
    a[i][2] = hi[2 * i];
    a[i][3] = hi[2 * i + 1];
  }
}

// n-tiles J0 .. J0 + NT - 1 of a matrix (mat: their B fragments) times the
// bytes of the quad's four operands x; emit(k, v) receives this thread's
// product's lazy 32-bit limb k (< 2^47) for k = 2 J0 .. 2 (J0 + NT) - 1 in
// order.
template <int J0, int NT, class Emit>
__device__ __forceinline__ void quad_matrix_product(const u32 x[8], const u32 (&mat)[NT][2],
                                                    int t, int base, Emit emit) {
  u32 a[2][4];
  quad_fragments(a, x, t, base);
#pragma unroll
  for (int j = 0; j < NT; j++) {
    u32 pk[4];  // role r's columns 8j + 2t and 8j + 2t + 1, packed
#pragma unroll
    for (int i = 0; i < 2; i++) {
      int32_t d[4];
      mma_u8(d, a[i], mat[j][0], mat[j][1]);
      pk[2 * i] = (u32)d[0] + ((u32)d[1] << 8);
      pk[2 * i + 1] = (u32)d[2] + ((u32)d[3] << 8);
    }
    u32 send[4], got[4], from[4];
    xperm4(send, pk, t);  // send[s]: role t ^ s's pair, which thread t ^ s owns
#pragma unroll
    for (int s = 0; s < 4; s++)  // got[s]: role t's pair from thread t ^ s
      got[s] = s ? __shfl_sync(kFull, send[s], base + (t ^ s)) : send[s];
    xperm4(from, got, t);  // from[t']: role t's pair from thread t'
    emit(2 * (J0 + j), (u64)from[0] + ((u64)from[1] << 16));
    emit(2 * (J0 + j) + 1, (u64)from[2] + ((u64)from[3] << 16));
  }
}

// mont_mul_mma's contract and digits, on the quad product. Every thread of
// the warp must call it together; thread t of each quad holds role t's
// operands. r may alias a or b.
__device__ __forceinline__ void mont_mul_mma_quad(u32 r[8], const u32 a[8], const u32 b[8],
                                                  const QuadConsts& k, int lane) {
  const int t = lane & 3, base = lane & ~3;
  u32 tw[16], m[8];
  mul_wide(tw, a, b);
  __syncwarp();  // the mma need the whole warp, converged
  u64 c = 0;
  quad_matrix_product<0>(tw, k.m1, t, base, [&](int i, u64 v) {  // true bytes of m mod 2^256
    c += v;
    m[i] = (u32)c;
    c >>= 32;
  });
  // q = ceil((T_lo + A 2^192) / 2^256) as the carry of a 128-bit sum
  // (lo, c): T_lo's limbs 6 and 7, 2^64 - 1, 1 if limbs 0..5 are not all
  // zero, and A = limb 6 + limb 7 * 2^32 of the lazy columns 24..31.
  const u32 low = tw[0] | tw[1] | tw[2] | tw[3] | tw[4] | tw[5];
  u64 lo = tw[6] | ((u64)tw[7] << 32);
  c = 0;
  auto add = [&](u64 v) {
    const u64 n = lo + v;
    c += n < lo;
    lo = n;
  };
  add(~0ull);
  add(low != 0);
  quad_matrix_product<kM2Tile0>(m, k.m2, t, base, [&](int i, u64 v) {
    if (i == 6) {
      add(v);
    } else if (i == 7) {
      add(v << 32);
      c += v >> 32;  // c is q from here on
    } else {  // limbs 8..15: T_hi + H + q
      c += v + tw[i];
      tw[i] = (u32)c;
      c >>= 32;
    }
  });
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = tw[8 + i];  // < 2p < 2^254
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

// ---------------------------------------------------------------------------
// accumulate_scan_gather_mma. The tensor-core counterpart of
// accumulate_scan_gather_kernel (padd_kernels.cu), for the same TPU kernel
// (_accumulate_scan_kernel with mul = kmont_mul_mxu): the same inputs (rows
// [M][24], perm [L][W], ids [L][W]) and outputs (partial [4][16][K*B], which
// the caller fills with the identity, final_acc [4][16][W], final_id [W]),
// digit for digit, with every product through mont_mul_mma_quad; m1 and m2
// as for accumulate_scan_mma_kernel, read once a thread into registers. No
// shared memory, so the block is the CIOS kernel's, 256 threads. Bound:
// that of the CIOS gathering scan, the same work (7 products a lane-step);
// the mma take about half of each product's multiplies off the integer
// pipe, and the 39 shuffled words and about 200 selects a product come on
// top.
// ---------------------------------------------------------------------------
constexpr int kGatherMmaThreads = 256;

extern "C" __global__ void __launch_bounds__(kGatherMmaThreads)
    accumulate_scan_gather_mma_kernel(const int4* __restrict__ rows,
                                      const int32_t* __restrict__ perm,
                                      const int32_t* __restrict__ ids,
                                      const u32* __restrict__ m1, const u32* __restrict__ m2,
                                      int32_t* __restrict__ partial,
                                      int32_t* __restrict__ final_acc,
                                      int32_t* __restrict__ final_id, int L, int W, int C, int B) {
  const int lane = threadIdx.x & 31;
  QuadConsts k;
  load_quad_consts(k, m1, m2, lane);
  gather_scan(rows, perm, ids, partial, final_acc, final_id, L, W, C, B,
              [&](u32 o[8], const u32 a[8], const u32 b[8]) { mont_mul_mma_quad(o, a, b, k, lane); });
}

extern "C" int launch_accumulate_scan_gather_mma(const void* rows, const void* perm,
                                                 const void* ids, const void* m1, const void* m2,
                                                 void* partial, void* final_acc, void* final_id,
                                                 int L, int W, int C, int B, int device,
                                                 void* stream) {
  if (const int err = use_device(device)) return err;
  const int grid = (4 * W + kGatherMmaThreads - 1) / kGatherMmaThreads;
  accumulate_scan_gather_mma_kernel<<<grid, kGatherMmaThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)rows, (const int32_t*)perm, (const int32_t*)ids, (const u32*)m1,
      (const u32*)m2, (int32_t*)partial, (int32_t*)final_acc, (int32_t*)final_id, L, W, C, B);
  return (int)cudaGetLastError();
}

extern "C" int occupancy_accumulate_scan_gather_mma(int* warps) {
  return warps_per_sm(accumulate_scan_gather_mma_kernel, kGatherMmaThreads, warps);
}
