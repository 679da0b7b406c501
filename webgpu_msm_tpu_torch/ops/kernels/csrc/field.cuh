// Fp and curve arithmetic for ed-on-bls12-377, as __device__ functions.
//
// Replaces the in-kernel digit arithmetic of the JAX package's
// ops/pallas/field_kernels.py (kmont_mul, kmont_mul_const, kadd, ksub,
// kneg, kmul_2d, _cond_sub_p) and the point formulas of
// ops/pallas/padd_kernels.py (_unified_add, _niels_add), with the doubling
// of ops/curve_ops.py.
//
// The TPU code works on 16 lazy 16-bit digits because its vector unit has
// no 32x32->64 multiply. Here a field element is 8 little-endian 32-bit
// limbs in registers and a product is a 64-bit multiply-add. R = 2^256 for
// both limb sizes, so every Montgomery residue, and every fully reduced
// result, equals the TPU kernel's digit for digit. Tensors keep the JAX
// layouts: [coord][16][...] planes of 16-bit digits held in 32-bit words,
// unpacked into limbs on load and split back on store.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace msm {

typedef uint32_t u32;
typedef uint64_t u64;

// p, R mod p, 2R mod p, R^2 mod p, 2d*R mod p and 2d*R^2 mod p (d = 3021) as
// 32-bit limbs, least significant first; N0 = -p^-1 mod 2^32. `static`: every
// source that includes this header keeps its own copy.
static __constant__ u32 P_L[8] = {0x00000001u, 0x0a118000u, 0xd0000001u, 0x59aa76feu,
                           0x5c37b001u, 0x60b44d1eu, 0x9a2ca556u, 0x12ab655eu};
static __constant__ u32 R_L[8] = {0xfffffff3u, 0x7d1c7fffu, 0x6ffffff2u, 0x7257f50fu,
                           0x512c0feeu, 0x16d81575u, 0x2bbb9a9du, 0x0d4bda32u};
static __constant__ u32 TWO_R_L[8] = {0xffffffe5u, 0xf0277fffu, 0x0fffffe3u, 0x8b057320u,
                               0x46206fdbu, 0xccfbddccu, 0xbd4a8fe3u, 0x07ec4f05u};
static __constant__ u32 R2_L[8] = {0xb861857bu, 0x25d577bau, 0x8860591fu, 0xcc2c27b5u,
                            0xe5dc8593u, 0xa7cc008fu, 0xeff1c939u, 0x011fdae7u};
static __constant__ u32 TWO_D_R_L[8] = {0xfffebc5fu, 0x967e7fffu, 0x2ffeafa4u, 0x87a7a94fu,
                                 0xbde89b04u, 0xb14e318du, 0xb55008a9u, 0x014ee2fau};
static __constant__ u32 TWO_D_R2_L[8] = {0xada85793u, 0xa95b4ce3u, 0xc1f767a9u, 0xa56a7723u,
                                  0x53b21056u, 0x251bea2au, 0x7338c947u, 0x10cbc8f0u};
constexpr u32 N0 = 0xffffffffu;

// a in [0, 2p) -> a mod p.
__device__ __forceinline__ void cond_sub_p(u32 a[8]) {
  u32 d[8];
  u32 borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 t = (u64)a[i] - P_L[i] - borrow;
    d[i] = (u32)t;
    borrow = (u32)(t >> 63);
  }
#pragma unroll
  for (int i = 0; i < 8; i++) a[i] = borrow ? a[i] : d[i];
}

// (a + b) mod p for a, b < p (kadd). r may alias a or b.
__device__ __forceinline__ void fadd(u32 r[8], const u32 a[8], const u32 b[8]) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (u64)a[i] + b[i];
    r[i] = (u32)c;
    c >>= 32;
  }
  cond_sub_p(r);  // a + b < 2p < 2^254: no carry out of limb 7
}

// (a - b) mod p for a, b < p (ksub). r may alias a or b.
__device__ __forceinline__ void fsub(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 t = (u64)a[i] - b[i] - borrow;
    r[i] = (u32)t;
    borrow = (u32)(t >> 63);
  }
  const u32 mask = 0u - borrow;
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (u64)r[i] + (P_L[i] & mask);
    r[i] = (u32)c;
    c >>= 32;
  }
}

// (-a) mod p with 0 -> 0 (kneg). r may alias a.
__device__ __forceinline__ void fneg(u32 r[8], const u32 a[8]) {
  u32 nz = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) nz |= a[i];
  const u32 mask = nz ? 0xffffffffu : 0u;
  u32 borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 t = (u64)(P_L[i] & mask) - a[i] - borrow;
    r[i] = (u32)t;
    borrow = (u32)(t >> 63);
  }
}

// CIOS Montgomery product a*b*R^-1 mod p (kmont_mul, kmont_mul_const).
// Needs a < 2^256 and b < p, so the result before the final subtraction is
// below 2p. r may alias a or b: it is written only at the end.
__device__ __forceinline__ void mont_mul(u32 r[8], const u32 a[8], const u32 b[8]) {
  u32 t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (u64)a[j] * b[i] + t[j];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (u32)c;
    t[9] = (u32)(c >> 32);
    const u32 m = t[0] * N0;
    c = ((u64)m * P_L[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (u64)m * P_L[j] + t[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (u32)c;
    t[8] = t[9] + (u32)(c >> 32);
  }
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = t[i];
  cond_sub_p(r);
}

// A constant's limbs into registers, so products take plain arrays.
__device__ __forceinline__ void load_const(u32 r[8], const u32 (&c)[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = c[i];
}

// Extended point (X, Y, T, Z), Montgomery domain.
struct Pt {
  u32 x[8], y[8], t[8], z[8];
};

__device__ __forceinline__ void set_identity(Pt& p) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    p.x[i] = 0;
    p.y[i] = R_L[i];
    p.t[i] = 0;
    p.z[i] = R_L[i];
  }
}

// Unified add-2008-hwcd-3 with a = -1 (_unified_add): 8 products plus the
// multiply by 2d. r may alias p or q.
__device__ __forceinline__ void unified_add(Pt& r, const Pt& p, const Pt& q) {
  u32 a[8], b[8], c[8], d[8], u[8], v[8];
  fsub(u, p.y, p.x);
  fsub(v, q.y, q.x);
  mont_mul(a, u, v);
  fadd(u, p.y, p.x);
  fadd(v, q.y, q.x);
  mont_mul(b, u, v);
  mont_mul(u, p.t, q.t);
  load_const(v, TWO_D_R_L);
  mont_mul(c, u, v);  // kmul_2d
  mont_mul(u, p.z, q.z);
  fadd(d, u, u);
  u32 e[8], f[8], g[8], h[8];
  fsub(e, b, a);
  fsub(f, d, c);
  fadd(g, d, c);
  fadd(h, b, a);
  mont_mul(r.x, e, f);
  mont_mul(r.y, g, h);
  mont_mul(r.t, e, h);
  mont_mul(r.z, f, g);
}

// Dedicated doubling dbl-2008-hwcd with a = -1 (curve_ops.double): 4
// squarings and 4 products. r may alias p.
__device__ __forceinline__ void point_double(Pt& r, const Pt& p) {
  u32 a[8], b[8], c[8], d[8], e[8], f[8], g[8], h[8];
  mont_mul(a, p.x, p.x);
  mont_mul(b, p.y, p.y);
  mont_mul(c, p.z, p.z);
  fadd(c, c, c);
  fneg(d, a);
  fsub(h, d, b);
  fadd(e, p.x, p.y);
  mont_mul(e, e, e);
  fadd(e, e, h);
  fadd(g, d, b);
  fsub(f, g, c);
  mont_mul(r.x, e, f);
  mont_mul(r.y, g, h);
  mont_mul(r.t, e, h);
  mont_mul(r.z, f, g);
}

// p + q with q in Niels form (y-x, y+x, 2d*t; z == 1) (_niels_add): 7
// products, each through `mul(r, a, b)`, a Montgomery product with the
// contract of mont_mul. r may alias p.
template <class Mul>
__device__ __forceinline__ void niels_add_with(Pt& r, const Pt& p, const u32 ym[8],
                                               const u32 yp[8], const u32 td[8], Mul mul) {
  u32 a[8], b[8], c[8], d[8], u[8];
  fsub(u, p.y, p.x);
  mul(a, u, ym);
  fadd(u, p.y, p.x);
  mul(b, u, yp);
  mul(c, p.t, td);
  fadd(d, p.z, p.z);
  u32 e[8], f[8], g[8], h[8];
  fsub(e, b, a);
  fsub(f, d, c);
  fadd(g, d, c);
  fadd(h, b, a);
  mul(r.x, e, f);
  mul(r.y, g, h);
  mul(r.t, e, h);
  mul(r.z, f, g);
}

// The Niels add on CIOS products.
__device__ __forceinline__ void niels_add(Pt& r, const Pt& p, const u32 ym[8],
                                          const u32 yp[8], const u32 td[8]) {
  niels_add_with(r, p, ym, yp, td,
                 [](u32 o[8], const u32 a[8], const u32 b[8]) { mont_mul(o, a, b); });
}

// One scan step's Niels operand at index `at` of packed planes [3][8][LW]
// (one 32-bit limb per word): with the sign flag set, y-x and y+x swap and
// 2d*t is negated.
__device__ __forceinline__ void load_niels_signed(u32 ym[8], u32 yp[8], u32 td[8],
                                                  const int32_t* pts, size_t LW, size_t at,
                                                  bool neg) {
  u32 ntd[8];
#pragma unroll
  for (int q = 0; q < 8; q++) {
    const u32 ym0 = (u32)pts[q * LW + at];
    const u32 yp0 = (u32)pts[(8 + q) * LW + at];
    ym[q] = neg ? yp0 : ym0;
    yp[q] = neg ? ym0 : yp0;
    td[q] = (u32)pts[(16 + q) * LW + at];
  }
  fneg(ntd, td);
#pragma unroll
  for (int q = 0; q < 8; q++) td[q] = neg ? ntd[q] : td[q];
}

// One coordinate from 16 digit planes: digit k of the element at `base`
// lies at src[k * stride + base]; two digits make one limb.
__device__ __forceinline__ void load_fp(u32 r[8], const int32_t* src, size_t stride,
                                        size_t base) {
#pragma unroll
  for (int i = 0; i < 8; i++)
    r[i] = (u32)src[(2 * i) * stride + base] | ((u32)src[(2 * i + 1) * stride + base] << 16);
}

__device__ __forceinline__ void store_fp(int32_t* dst, size_t stride, size_t base,
                                         const u32 a[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    dst[(2 * i) * stride + base] = (int32_t)(a[i] & 0xffffu);
    dst[(2 * i + 1) * stride + base] = (int32_t)(a[i] >> 16);
  }
}

// A point from [4][16][...] planes: coordinate c starts at 16 * c * stride.
__device__ __forceinline__ void load_pt(Pt& p, const int32_t* src, size_t stride, size_t base) {
  load_fp(p.x, src, stride, base);
  load_fp(p.y, src, stride, base + 16 * stride);
  load_fp(p.t, src, stride, base + 32 * stride);
  load_fp(p.z, src, stride, base + 48 * stride);
}

__device__ __forceinline__ void store_pt(int32_t* dst, size_t stride, size_t base, const Pt& p) {
  store_fp(dst, stride, base, p.x);
  store_fp(dst, stride, base + 16 * stride, p.y);
  store_fp(dst, stride, base + 32 * stride, p.t);
  store_fp(dst, stride, base + 48 * stride, p.z);
}

// Host side, first in every launch function: make `device`, the device of
// the launch's tensors, current on the calling thread. The runtime launches
// on its current device, which need not be theirs when a process drives
// several cards. 0 on success, else the runtime's error.
inline int use_device(int device) { return (int)cudaSetDevice(device); }

// Host side: how many warps of `kernel`, launched in blocks of `threads`,
// one SM holds at once (registers and shared memory both count), into
// *warps. 0 on success, else the runtime's error.
template <class Kernel>
inline int warps_per_sm(Kernel kernel, int threads, int* warps) {
  int blocks = 0;
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  *warps = blocks * threads / 32;
  return err;
}

}  // namespace msm
