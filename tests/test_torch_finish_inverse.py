"""The divstep (safegcd) inverse of the `finish_affine_divsteps` kernel
(`csrc/padd_kernels.cu`), modelled in Python integers step for step:
the same 9 limbs of 30 bits, batches of 30 branch-free divsteps on u32
words that wrap, the same matrix updates of f, g, d and e with their
int64 sums and the multiples of p that clear the low limb, the same
normalization and the same limb conversions. The model asserts every
range the kernel relies on (int32 limbs and matrix entries, int64 sums,
d and e in (-2p, p), at most the kernel's number of batches) and is held
against the port's oracle (`oracle.field.finv`, Python `pow`) and, through
the kernel's three Montgomery products, against `finish_affine_plain`
digit for digit. No card and no JAX: a fault of the arithmetic shows here
before the kernel runs.
"""
import math
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from webgpu_msm_tpu_torch.ops.kernels import build
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle import field as F
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy, planes_to_numpy

from torch_inputs import mont_window_sums
from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

P = F.P
U32, M30 = (1 << 32) - 1, (1 << 30) - 1
BATCH = 30  # divsteps a batch: the limb width
MAX_BATCHES = 25  # the kernel's loop bound
P30 = [(P >> (30 * i)) & M30 for i in range(9)]
P_INV30 = 1  # p^-1 mod 2^30
EDGES = (0, 1, 2, P - 1, P - 2, F.R % P, F.R * F.R % P)


def s32(x: int) -> int:
    """The low 32 bits of x as an int32."""
    x &= U32
    return x - (1 << 32) if x >> 31 else x


def i32(x: int) -> int:
    assert -(1 << 31) <= x < 1 << 31, x
    return x


def i64(x: int) -> int:
    assert -(1 << 63) <= x < 1 << 63, x
    return x


def value(limbs) -> int:
    return sum(v << (30 * i) for i, v in enumerate(limbs))


def check_limbs(limbs) -> None:
    """Lower limbs in [0, 2^30), the top one an int32."""
    assert all(0 <= v <= M30 for v in limbs[:8]), limbs
    i32(limbs[8])


def divsteps_30(zeta: int, f: int, g: int):
    """`divsteps_30`: zeta (int32), f and g (u32 low words), u32 matrix
    entries that wrap; returns (zeta, (u, v, q, r)) as int32."""
    u, v, q, r = 1, 0, 0, 1
    for _ in range(BATCH):
        c1 = (zeta >> 31) & U32
        c2 = (-(g & 1)) & U32
        g = (g + (((f ^ c1) - c1) & c2)) & U32
        q = (q + (((u ^ c1) - c1) & c2)) & U32
        r = (r + (((v ^ c1) - c1) & c2)) & U32
        c = c1 & c2
        zeta = i32((zeta ^ s32(c)) - 1)
        f = (f + (g & c)) & U32
        u = (u + (q & c)) & U32
        v = (v + (r & c)) & U32
        g >>= 1
        u = (u << 1) & U32
        v = (v << 1) & U32
    t = tuple(s32(x) for x in (u, v, q, r))
    assert abs(t[0]) + abs(t[1]) <= 1 << 30 and abs(t[2]) + abs(t[3]) <= 1 << 30, t
    return zeta, t


def update_fg_30(f, g, t):
    u, v, q, r = t
    cf = i64(i64(u * f[0]) + i64(v * g[0]))
    cg = i64(i64(q * f[0]) + i64(r * g[0]))
    assert cf & M30 == 0 and cg & M30 == 0
    cf >>= 30
    cg >>= 30
    f, g = list(f), list(g)
    for i in range(1, 9):
        cf = i64(cf + i64(i64(u * f[i]) + i64(v * g[i])))
        cg = i64(cg + i64(i64(q * f[i]) + i64(r * g[i])))
        f[i - 1], g[i - 1] = cf & M30, cg & M30
        cf >>= 30
        cg >>= 30
    f[8], g[8] = i32(cf), i32(cg)
    return f, g


def update_de_30(d, e, t):
    u, v, q, r = t
    sd, se = d[8] >> 31, e[8] >> 31  # 0 or -1
    md = i32((u & sd) + (v & se))
    me = i32((q & sd) + (r & se))
    cd = i64(i64(u * d[0]) + i64(v * e[0]))
    ce = i64(i64(q * d[0]) + i64(r * e[0]))
    md = i32(md - ((P_INV30 * (cd & U32) + (md & U32)) & U32 & M30))
    me = i32(me - ((P_INV30 * (ce & U32) + (me & U32)) & U32 & M30))
    cd = i64(cd + i64(P30[0] * md))
    ce = i64(ce + i64(P30[0] * me))
    assert cd & M30 == 0 and ce & M30 == 0
    cd >>= 30
    ce >>= 30
    d, e = list(d), list(e)
    for i in range(1, 9):
        cd = i64(cd + i64(i64(i64(u * d[i]) + i64(v * e[i])) + i64(P30[i] * md)))
        ce = i64(ce + i64(i64(i64(q * d[i]) + i64(r * e[i])) + i64(P30[i] * me)))
        d[i - 1], e[i - 1] = cd & M30, ce & M30
        cd >>= 30
        ce >>= 30
    d[8], e[8] = i32(cd), i32(ce)
    return d, e


def add_p_if_negative(d):
    add = d[8] >> 31
    return [i32(x + (p & add)) for x, p in zip(d, P30)]


def carry_30(d):
    for i in range(1, 9):
        d[i] = i32(d[i] + (d[i - 1] >> 30))
        d[i - 1] &= M30
    return d


def normalize_30(d, sign: int):
    """d in (-2p, p) times the sign of `sign` into [0, p)."""
    d = add_p_if_negative(d)
    neg = sign >> 31
    d = carry_30([i32((x ^ neg) - neg) for x in d])
    d = carry_30(add_p_if_negative(d))
    check_limbs(d)
    assert 0 <= value(d) < P
    return d


def to_limbs30(a):
    """8 u32 limbs -> 9 limbs of 30 bits (`to_limbs30`)."""
    r = []
    for i in range(9):
        w, s = 30 * i // 32, 30 * i % 32
        x = a[w] >> s
        if s > 2 and w < 7:
            x |= (a[w + 1] << (32 - s)) & U32
        r.append(x & M30)
    return r


def from_limbs30(a):
    """9 limbs of 30 bits (a value below 2^256) -> 8 u32 limbs (`from_limbs30`)."""
    r = []
    for j in range(8):
        i, s = 32 * j // 30, 32 * j % 30
        assert s <= 14
        r.append(((a[i] & U32) >> s | (a[i + 1] << (30 - s))) & U32)
    return r


def words(x: int):
    return [(x >> (32 * i)) & U32 for i in range(8)]


def inverse(z: int):
    """The kernel's inverse of z < 2^256: (z^-1 mod p, 0 for z = 0; batches run)."""
    f, g, d, e = list(P30), to_limbs30(words(z)), [0] * 9, [1] + [0] * 8
    assert value(g) == z
    zeta, batches = -1, 0
    for _ in range(MAX_BATCHES):
        if not any(g):
            break
        zeta, t = divsteps_30(zeta, f[0] & U32, g[0] & U32)
        d, e = update_de_30(d, e, t)
        f, g = update_fg_30(f, g, t)
        batches += 1
        for limbs in (f, g, d, e):
            check_limbs(limbs)
        assert -2 * P < value(d) < P and -2 * P < value(e) < P
        assert abs(value(f)) <= max(P, z) and abs(value(g)) <= max(P, z)
        assert (value(d) * z - value(f)) % P == 0 and (value(e) * z - value(g)) % P == 0
    assert not any(g), f"g != 0 after {MAX_BATCHES} batches"
    assert abs(value(f)) == (1 if z % P else P)
    out = from_limbs30(normalize_30(d, f[8]))
    return sum(w << (32 * i) for i, w in enumerate(out)), batches


def finish_affine_model(mont: np.ndarray) -> np.ndarray:
    """The kernel on Montgomery window sums [4, 16, K] uint32: the inverse
    of the residue z, by R^2 to plain z^-1, then x and y by it."""
    digits = mont.astype(object)
    ints = [[sum(int(digits[c, i, k]) << (16 * i) for i in range(16)) for k in range(mont.shape[-1])]
            for c in range(4)]
    out = np.zeros((2, 16, mont.shape[-1]), dtype=np.uint32)
    r2 = F.R * F.R % P
    for k, z in enumerate(ints[3]):
        zi = F.mont_mul(inverse(z)[0], r2)
        for c in (0, 1):
            v = F.mont_mul(ints[c][k], zi)
            out[c, :, k] = [(v >> (16 * i)) & 0xFFFF for i in range(16)]
    return out


def seeded_residues(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def test_the_model_uses_the_kernels_constants():
    """Batch length, loop bound, p's limbs and p^-1 mod 2^30 as the kernel
    source states them; the bound covers CHES 2019's 733 divsteps for
    253-bit inputs."""
    src = (build.CSRC / "padd_kernels.cu").read_text()
    const = lambda name: int(re.search(rf"{name} = (\d+);", src).group(1))
    assert const("kDivstepBatch") == BATCH
    assert const("kDivstepMaxBatches") == MAX_BATCHES == math.ceil(math.ceil((49 * 253 + 57) / 17) / BATCH)
    assert const("kPInv30") == P_INV30 and P * P_INV30 % (1 << 30) == 1
    limbs = re.search(r"P30\[9\] = \{([^}]*)\}", src).group(1)
    assert [int(x) for x in limbs.split(",")] == P30 and value(P30) == P


@pytest.mark.parametrize("z", EDGES, ids=["0", "1", "2", "p-1", "p-2", "R", "R^2"])
def test_inverse_of_edge_values_matches_the_oracle(z):
    """z = 0 runs no batch and gives 0, as `finv_mont` (the oracle raises)."""
    got, batches = inverse(z)
    assert got == (F.finv(z) if z else 0)
    assert batches <= MAX_BATCHES and (batches == 0) == (z == 0)


def test_inverse_of_seeded_and_structured_residues_matches_the_oracle():
    """300 seeded residues, every power of two below p and p minus each:
    equal to `finv`, within the loop bound; random z takes 17-18 batches."""
    zs = seeded_residues(300, 15) + [1 << k for k in range(253)] + [P - (1 << k) for k in range(253)]
    batches = []
    for z in zs:
        got, b = inverse(z)
        assert got == F.finv(z) and got * z % P == 1
        batches.append(b)
    assert max(batches) <= MAX_BATCHES
    assert set(batches[:300]) <= {16, 17, 18, 19}


@settings(max_examples=150, deadline=None)
@given(st.integers(min_value=1, max_value=(1 << 256) - 1).filter(lambda z: z % P))
def test_inverse_of_any_256_bit_word_matches_the_oracle(z):
    """Any 256-bit word that is not a multiple of p, reduced or not: the
    loop bound holds for 256-bit inputs too."""
    assert inverse(z)[0] == F.finv(z % P)


def test_limb_conversions_round_trip():
    for z in EDGES + ((1 << 256) - 1, P - 1) + tuple(seeded_residues(20, 16)):
        limbs = to_limbs30(words(z))
        check_limbs(limbs)
        assert value(limbs) == z and from_limbs30(limbs) == words(z)


@pytest.mark.parametrize("K", [16, 20])
def test_the_kernels_finish_equals_finish_affine_plain(K):
    """The model of the whole kernel at the resident (K 16) and wire (K 20)
    windows, with the edge values as z in the first lanes after the z = 0
    lane, digit for digit the plain version's (the Fermat chain)."""
    mont = mont_window_sums(np.random.default_rng(200 + K), K)
    for lane, z in enumerate(EDGES[1:], start=2):
        mont[3, :, lane] = [(z >> (16 * i)) & 0xFFFF for i in range(16)]
    want = planes_to_numpy(pk.finish_affine_divsteps(planes_from_numpy(mont)))
    np.testing.assert_array_equal(finish_affine_model(mont), want)
    assert not want[:, :, 1].any()


def test_wrapper_on_cpu_tensors_runs_the_plain_version_uncounted():
    mont = planes_from_numpy(mont_window_sums(np.random.default_rng(201), 3))
    pk.reset_launch_counts()
    got = pk.finish_affine_divsteps(mont)
    assert torch.equal(got, pk.finish_affine_plain(mont)) and got.dtype == torch.int32
    assert pk.launches == {name: 0 for name in pk.KERNELS}
    with pytest.raises(ValueError, match="finish_affine_divsteps"):
        pk.finish_affine_divsteps(mont[:3].contiguous())
