// Native CPU MSM engine: Pippenger over the Aleo embedded twisted Edwards
// curve (ed-on-bls12-377), 4x64-bit-limb Montgomery field arithmetic.
//
// The TPU build's counterpart of the reference's Rust msm-wasm crate
// (src/submission/msm-wasm/src/lib.rs): windowed scalar split (lib.rs:58-84),
// serial per-window bucket accumulation (bucket_cpu, lib.rs:24-44),
// running-sum bucket reduction (bucket_sum_cpu, lib.rs:46-56), window combine
// with w doublings per window (reduce_last, lib.rs:88-104), parallelized over
// windows (rayon par_chunks -> OpenMP parallel-for), plus the affine add used
// to join co-compute partials (point_add_affine, lib.rs:240-251).
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace {

// ---- field constants (4x64 LE limbs) ----
// p = 8444461749428370424248824938781546531375899335154063827935233455917409239041
static const u64 P[4] = {0x0a11800000000001ULL, 0x59aa76fed0000001ULL,
                         0x60b44d1e5c37b001ULL, 0x12ab655e9a2ca556ULL};
static const u64 N0 = 0x0a117fffffffffffULL;  // -p^-1 mod 2^64
static const u64 R2[4] = {0x25d577bab861857bULL, 0xcc2c27b58860591fULL,
                          0xa7cc008fe5dc8593ULL, 0x011fdae7eff1c939ULL};
static const u64 ONE_M[4] = {0x7d1c7ffffffffff3ULL, 0x7257f50f6ffffff2ULL,
                             0x16d81575512c0feeULL, 0x0d4bda322bbb9a9dULL};  // R mod p
static const u64 D_M[4] = {0xd047ffffffff5e30ULL, 0xf0a91026ffff57d2ULL,
                           0x09013f560d102582ULL, 0x09fd242ca7be5700ULL};  // d*R mod p

struct Fp {
  u64 v[4];
};

static inline bool gte_p(const u64 a[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] > P[i]) return true;
    if (a[i] < P[i]) return false;
  }
  return true;  // equal
}

static inline void sub_p(u64 a[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - P[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

static inline void fadd(Fp &o, const Fp &a, const Fp &b) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    o.v[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || gte_p(o.v)) sub_p(o.v);
}

static inline void fsub(Fp &o, const Fp &a, const Fp &b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    o.v[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (borrow) {  // add p back
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)o.v[i] + P[i] + carry;
      o.v[i] = (u64)s;
      carry = s >> 64;
    }
  }
}

// CIOS Montgomery multiplication (Koc-Acar-Kaliski), 4x64.
static inline void fmul(Fp &out, const Fp &a, const Fp &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)t[j] + (u128)a.v[j] * b.v[i] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);

    u64 m = t[0] * N0;
    u128 cur = (u128)t[0] + (u128)m * P[0];
    carry = cur >> 64;
    for (int j = 1; j < 4; ++j) {
      cur = (u128)t[j] + (u128)m * P[j] + carry;
      t[j - 1] = (u64)cur;
      carry = cur >> 64;
    }
    s = (u128)t[4] + carry;
    t[3] = (u64)s;
    t[4] = t[5] + (u64)(s >> 64);
  }
  for (int i = 0; i < 4; ++i) out.v[i] = t[i];
  if (t[4] || gte_p(out.v)) sub_p(out.v);
}

static inline void fsqr(Fp &o, const Fp &a) { fmul(o, a, a); }

static inline void to_mont(Fp &o, const Fp &a) {
  Fp r2;
  std::memcpy(r2.v, R2, sizeof(R2));
  fmul(o, a, r2);
}

static inline void from_mont(Fp &o, const Fp &a) {
  Fp one;
  one.v[0] = 1; one.v[1] = one.v[2] = one.v[3] = 0;
  fmul(o, a, one);
}

// a^(p-2) in Montgomery form (inverse); a must be nonzero.
static void finv(Fp &o, const Fp &a) {
  // exponent = p - 2
  u64 e[4];
  std::memcpy(e, P, sizeof(P));
  e[0] -= 2;  // p is odd and > 2, no borrow
  Fp result;
  std::memcpy(result.v, ONE_M, sizeof(ONE_M));
  Fp base = a;
  for (int limb = 0; limb < 4; ++limb) {
    for (int bit = 0; bit < 64; ++bit) {
      if ((e[limb] >> bit) & 1) fmul(result, result, base);
      fsqr(base, base);
    }
  }
  o = result;
}

// ---- extended twisted Edwards (a = -1, d = 3021); curve.wgsl:36-114 ----
struct Pt {
  Fp x, y, t, z;
};

static inline void pt_identity(Pt &p) {
  std::memset(&p, 0, sizeof(p));
  std::memcpy(p.y.v, ONE_M, sizeof(ONE_M));
  std::memcpy(p.z.v, ONE_M, sizeof(ONE_M));
}

// unified add-2008-hwcd, a = -1
static inline void pt_add(Pt &o, const Pt &p1, const Pt &p2) {
  Fp a, b, tt, c, d, e, f, g, h, tmp1, tmp2;
  Fp dm;
  std::memcpy(dm.v, D_M, sizeof(D_M));
  fmul(a, p1.x, p2.x);
  fmul(b, p1.y, p2.y);
  fmul(tt, p1.t, p2.t);
  fmul(c, tt, dm);
  fmul(d, p1.z, p2.z);
  fadd(tmp1, p1.x, p1.y);
  fadd(tmp2, p2.x, p2.y);
  fmul(e, tmp1, tmp2);
  fadd(tmp1, a, b);
  fsub(e, e, tmp1);
  fsub(f, d, c);
  fadd(g, d, c);
  fadd(h, b, a);  // b - a*A with A = -1
  fmul(o.x, e, f);
  fmul(o.y, g, h);
  fmul(o.t, e, h);
  fmul(o.z, f, g);
}

// mixed add: p2.z == 1 (saves z1*z2)
static inline void pt_add_mixed(Pt &o, const Pt &p1, const Fp &x2, const Fp &y2,
                                const Fp &t2) {
  Fp a, b, tt, c, e, f, g, h, tmp1, tmp2;
  Fp dm;
  std::memcpy(dm.v, D_M, sizeof(D_M));
  fmul(a, p1.x, x2);
  fmul(b, p1.y, y2);
  fmul(tt, p1.t, t2);
  fmul(c, tt, dm);
  const Fp &d = p1.z;
  fadd(tmp1, p1.x, p1.y);
  fadd(tmp2, x2, y2);
  fmul(e, tmp1, tmp2);
  fadd(tmp1, a, b);
  fsub(e, e, tmp1);
  fsub(f, d, c);
  fadd(g, d, c);
  fadd(h, b, a);
  fmul(o.x, e, f);
  fmul(o.y, g, h);
  fmul(o.t, e, h);
  fmul(o.z, f, g);
}

// dbl-2008-hwcd, a = -1
static inline void pt_double(Pt &o, const Pt &p) {
  Fp a, b, zz, c, d, e, f, g, h, tmp;
  fsqr(a, p.x);
  fsqr(b, p.y);
  fsqr(zz, p.z);
  fadd(c, zz, zz);
  // d = -a
  Fp zero;
  std::memset(&zero, 0, sizeof(zero));
  fsub(d, zero, a);
  fsub(h, d, b);
  fadd(tmp, p.x, p.y);
  fsqr(e, tmp);
  fadd(e, e, h);
  fadd(g, d, b);
  fsub(f, g, c);
  fmul(o.x, e, f);
  fmul(o.y, g, h);
  fmul(o.t, e, h);
  fmul(o.z, f, g);
}

static inline u64 window_digit(const u64 sc[4], int k, int w) {
  int bit0 = k * w;
  int limb = bit0 >> 6;
  int off = bit0 & 63;
  u64 val = sc[limb] >> off;
  if (off + w > 64 && limb + 1 < 4) val |= sc[limb + 1] << (64 - off);
  return val & ((1ULL << w) - 1);
}

}  // namespace

extern "C" {

// points: [n][3][4] u64 LE limbs (x, y, t), plain domain, z == 1 implied.
// scalars: [n][4] u64 LE. out_xy: [2][4] u64 LE plain affine (x, y).
// Returns 0 on success.
int msm_run(const u64 *points, const u64 *scalars, size_t n, int window_bits,
            int n_threads, u64 *out_xy) {
  if (window_bits < 2 || window_bits > 24 || n == 0) return 1;
  const int w = window_bits;
  const int n_windows = (256 + w - 1) / w;
  const size_t n_buckets = 1ULL << w;

#ifdef _OPENMP
  if (n_threads > 0) omp_set_num_threads(n_threads);
#endif

  // Convert points to Montgomery once (parallel over points).
  std::vector<Fp> mx(n), my(n), mt(n);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (long long i = 0; i < (long long)n; ++i) {
    Fp p;
    std::memcpy(p.v, points + i * 12 + 0, 32);
    to_mont(mx[i], p);
    std::memcpy(p.v, points + i * 12 + 4, 32);
    to_mont(my[i], p);
    std::memcpy(p.v, points + i * 12 + 8, 32);
    to_mont(mt[i], p);
  }

  // Per-window bucket accumulate + running-sum reduce (parallel over windows;
  // the reference's rayon par_chunks over windows, lib.rs:116-119).
  std::vector<Pt> window_sums(n_windows);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (int k = 0; k < n_windows; ++k) {
    std::vector<Pt> buckets(n_buckets);
    std::vector<unsigned char> used(n_buckets, 0);
    for (size_t i = 0; i < n; ++i) {
      u64 b = window_digit(scalars + i * 4, k, w);
      if (b == 0) continue;
      if (!used[b]) {
        buckets[b].x = mx[i];
        buckets[b].y = my[i];
        buckets[b].t = mt[i];
        std::memcpy(buckets[b].z.v, ONE_M, sizeof(ONE_M));
        used[b] = 1;
      } else {
        pt_add_mixed(buckets[b], buckets[b], mx[i], my[i], mt[i]);
      }
    }
    // running sum: W = sum_b b * S_b  (bucket_sum_cpu, lib.rs:46-56)
    Pt running, total;
    pt_identity(running);
    pt_identity(total);
    for (size_t b = n_buckets - 1; b >= 1; --b) {
      if (used[b]) pt_add(running, running, buckets[b]);
      pt_add(total, total, running);
    }
    window_sums[k] = total;
  }

  // Window combine, MSB window first: res = 2^w * res + W_k (reduce_last).
  Pt res;
  pt_identity(res);
  for (int k = n_windows - 1; k >= 0; --k) {
    for (int d = 0; d < w; ++d) pt_double(res, res);
    pt_add(res, res, window_sums[k]);
  }

  // Affine: (x/z, y/z), out of Montgomery.
  Fp zinv, xa, ya;
  finv(zinv, res.z);
  fmul(xa, res.x, zinv);
  fmul(ya, res.y, zinv);
  from_mont(xa, xa);
  from_mont(ya, ya);
  std::memcpy(out_xy + 0, xa.v, 32);
  std::memcpy(out_xy + 4, ya.v, 32);
  return 0;
}

// Affine + affine -> affine (join of co-compute partials; lib.rs:240-251).
// p1/p2/out: [2][4] u64 LE plain affine (x, y).
int point_add_affine(const u64 *p1, const u64 *p2, u64 *out) {
  Pt a, b, s;
  Fp tmp;
  std::memcpy(tmp.v, p1 + 0, 32);
  to_mont(a.x, tmp);
  std::memcpy(tmp.v, p1 + 4, 32);
  to_mont(a.y, tmp);
  fmul(a.t, a.x, a.y);
  Fp one_m;
  std::memcpy(one_m.v, ONE_M, sizeof(ONE_M));
  // t is x*y*R^-1... need t = x*y in Montgomery: fmul gives (xR)(yR)R^-1 = xyR. OK.
  a.z = one_m;
  std::memcpy(tmp.v, p2 + 0, 32);
  to_mont(b.x, tmp);
  std::memcpy(tmp.v, p2 + 4, 32);
  to_mont(b.y, tmp);
  fmul(b.t, b.x, b.y);
  b.z = one_m;
  pt_add(s, a, b);
  Fp zinv, xa, ya;
  finv(zinv, s.z);
  fmul(xa, s.x, zinv);
  fmul(ya, s.y, zinv);
  from_mont(xa, xa);
  from_mont(ya, ya);
  std::memcpy(out + 0, xa.v, 32);
  std::memcpy(out + 4, ya.v, 32);
  return 0;
}

int msm_version() { return 1; }

}  // extern "C"
