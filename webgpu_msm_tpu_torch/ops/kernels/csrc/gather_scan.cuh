// The body of the gathering scan, shared by its CIOS kernel
// (accumulate_scan_gather_kernel, padd_kernels.cu) and its tensor-core
// kernel (accumulate_scan_gather_mma_kernel, mma_kernels.cu), so that the two
// cannot drift apart: a template over the Montgomery product, as
// niels_add_with (field.cuh) is.
//
// Four threads a lane: thread `role` of a lane owns coordinate `role` of the
// accumulator (X, Y, T, Z). A step is two rounds of one product a thread,
// `mul(r, a, b)` with a on the accumulator's side and b on the row's:
// A = (Y-X)*ym, B = (Y+X)*yp, C = T*td and D = Z*2R (= 2Z), then, with A..D
// passed round by shuffle, X = E*F, Y = G*H, T = E*H, Z = F*G. Both products
// of a step sit outside every lane-dependent branch, and lanes beyond W
// shadow lane W-1 and store nothing, so every thread of a warp reaches each
// product together: a warp-wide product (the tensor cores' mma) may run
// there. The contract is accumulate_scan_gather_kernel's (padd_kernels.cu).
#pragma once

#include "field.cuh"

namespace msm {

template <class Mul>
__device__ __forceinline__ void gather_scan(const int4* __restrict__ rows,
                                            const int32_t* __restrict__ perm,
                                            const int32_t* __restrict__ ids,
                                            int32_t* __restrict__ partial,
                                            int32_t* __restrict__ final_acc,
                                            int32_t* __restrict__ final_id, int L, int W, int C,
                                            int B, Mul mul) {
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int role = gt & 3;
  const bool live = (gt >> 2) < W;
  const int w = live ? (gt >> 2) : W - 1;
  const int base = (threadIdx.x & 31) & ~3;  // this lane's role-0 thread in the warp
  const size_t KB = (size_t)(W / C) * B;
  const size_t bucket0 = (size_t)(w / C) * B;
  const bool is_one = (role & 1) != 0;  // the identity: Y and Z are R, X and T are 0
  u32 own[8];
#pragma unroll
  for (int q = 0; q < 8; q++) own[q] = is_one ? R_L[q] : 0u;
  u32 acc_id = 0xffffffffu;

  // Round 1's second operand: role 0 takes y-x and role 1 y+x (the other way
  // round under the sign flag), role 2 takes 2d*t, role 3 the constant 2R.
  auto load_part = [&](int4 r[2], int p, u32 raw) {
    const bool neg = (raw >> 31) != 0;
    const int part = role == 2 ? 2 : ((role == 0) != neg ? 0 : 1);
    if (role != 3) {
      const int4* src = rows + (size_t)p * 6 + part * 2;
      r[0] = __ldg(src);
      r[1] = __ldg(src + 1);
    }
  };
  int4 nxt[2] = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
  u32 raw_nxt = (u32)ids[w];
  int p2 = L > 1 ? perm[W + w] : 0;
  u32 raw2 = L > 1 ? (u32)ids[W + w] : 0u;
  load_part(nxt, perm[w], raw_nxt);
  for (int l = 0; l < L; l++) {
    const int4 c0 = nxt[0], c1 = nxt[1];
    const u32 raw = raw_nxt;
    if (l + 1 < L) {  // step l + 1's operand, then step l + 2's row and id
      load_part(nxt, p2, raw2);
      raw_nxt = raw2;
    }
    if (l + 2 < L) {
      p2 = perm[(size_t)(l + 2) * W + w];
      raw2 = (u32)ids[(size_t)(l + 2) * W + w];
    }
    const u32 id = raw & 0x7fffffffu;
    const bool neg = (raw >> 31) != 0;
    u32 opb[8] = {(u32)c0.x, (u32)c0.y, (u32)c0.z, (u32)c0.w,
                  (u32)c1.x, (u32)c1.y, (u32)c1.z, (u32)c1.w};
    u32 nb[8];
    fneg(nb, opb);
#pragma unroll
    for (int q = 0; q < 8; q++) {
      if (role == 2 && neg) opb[q] = nb[q];
      if (role == 3) opb[q] = TWO_R_L[q];
    }
    if (id != acc_id) {  // a run ends: its in-lane sum goes to its bucket
      if (acc_id < (u32)B && live)
        store_fp(partial + (size_t)role * 16 * KB, KB, bucket0 + acc_id, own);
#pragma unroll
      for (int q = 0; q < 8; q++) own[q] = is_one ? R_L[q] : 0u;
    }
    acc_id = id;
    u32 other[8], dif[8], sum[8], u[8], r1[8];
#pragma unroll
    for (int q = 0; q < 8; q++) other[q] = __shfl_xor_sync(0xffffffffu, own[q], 1);
    fsub(dif, other, own);  // role 0: Y - X
    fadd(sum, own, other);  // role 1: Y + X
#pragma unroll
    for (int q = 0; q < 8; q++) u[q] = role == 0 ? dif[q] : (role == 1 ? sum[q] : own[q]);
    mul(r1, u, opb);
    u32 a[8], b[8], c[8], d[8], e[8], f[8], g[8], h[8], lhs[8], rhs[8];
#pragma unroll
    for (int q = 0; q < 8; q++) {
      a[q] = __shfl_sync(0xffffffffu, r1[q], base);
      b[q] = __shfl_sync(0xffffffffu, r1[q], base + 1);
      c[q] = __shfl_sync(0xffffffffu, r1[q], base + 2);
      d[q] = __shfl_sync(0xffffffffu, r1[q], base + 3);
    }
    fsub(e, b, a);
    fsub(f, d, c);
    fadd(g, d, c);
    fadd(h, b, a);
#pragma unroll
    for (int q = 0; q < 8; q++) {
      lhs[q] = role == 1 ? g[q] : (role == 3 ? f[q] : e[q]);
      rhs[q] = role == 0 ? f[q] : (role == 3 ? g[q] : h[q]);
    }
    mul(own, lhs, rhs);
  }
  if (live) {
    store_fp(final_acc + (size_t)role * 16 * W, (size_t)W, w, own);
    if (role == 0) final_id[w] = (int32_t)acc_id;
  }
}

}  // namespace msm
