"""The port's field, curve and window ops against the JAX package, digit
for digit, and against the bigint oracle.

Inputs are made with numpy from seeds and handed to both packages as u32
planes (`webgpu_msm_tpu_torch.utils.interop`); JAX runs on the CPU.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.ops import curve_ops as jcurve
from webgpu_msm_tpu.ops import field_ops as jfield
from webgpu_msm_tpu.ops import limbs as jlimbs
from webgpu_msm_tpu.ops import windows as jwindows
from webgpu_msm_tpu.oracle import field as F

from webgpu_msm_tpu_torch.ops import curve_ops, field_ops, limbs, windows
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy, planes_to_numpy

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

N = 24


def rand_elems(rng, n, bound=F.P):
    """n python ints in [0, bound), with the edge values 0, 1, bound-1."""
    vals = [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n - 3)]
    return vals + [0, 1, bound - 1]


def to_planes(vals) -> np.ndarray:
    """ints -> [16, n] uint32 digit planes."""
    return np.array([[(v >> (16 * k)) & 0xFFFF for v in vals] for k in range(16)], np.uint32)


def from_planes(arr) -> list[int]:
    arr = np.asarray(arr, dtype=np.uint64)
    return [sum(int(arr[k, i]) << (16 * k) for k in range(16)) for i in range(arr.shape[1])]


def port(a: np.ndarray) -> torch.Tensor:
    return limbs.as_i64(planes_from_numpy(a))


def jax_digits(a: np.ndarray):
    return jlimbs.unstack(jnp.asarray(a))


def jax_np(digits) -> np.ndarray:
    return np.asarray(jnp.stack(list(digits)))


C = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321 * 7919

FIELD_CASES = {
    "add": (2, jfield.field_add, field_ops.field_add, lambda a, b: F.fadd(a, b)),
    "sub": (2, jfield.field_sub, field_ops.field_sub, lambda a, b: F.fsub(a, b)),
    "neg": (1, jfield.field_neg, field_ops.field_neg, lambda a: F.fneg(a)),
    "mont_mul": (2, jfield.mont_mul, field_ops.mont_mul,
                 lambda a, b: a * b * pow(F.R, -1, F.P) % F.P),
    "mont_mul_const": (1, lambda a: jfield.mont_mul_const(a, C),
                       lambda a: field_ops.mont_mul_const(a, C),
                       lambda a: a * C * pow(F.R, -1, F.P) % F.P),
    "mul_plain_const": (1, lambda a: jfield.mul_plain_const(a, 6042),
                        lambda a: field_ops.mul_plain_const(a, 6042),
                        lambda a: a * 6042 % F.P),
    "to_mont": (1, jfield.to_mont, field_ops.to_mont, F.to_mont),
    "from_mont": (1, jfield.from_mont, field_ops.from_mont, F.from_mont),
}


@pytest.mark.parametrize("name", list(FIELD_CASES))
def test_field_op_matches_jax_and_oracle(name):
    arity, jfn, tfn, ofn = FIELD_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    args = [to_planes(rand_elems(rng, N)) for _ in range(arity)]
    got = planes_to_numpy(tfn(*(port(a) for a in args)))
    want = jax_np(jfn(*(jax_digits(a) for a in args)))
    np.testing.assert_array_equal(got, want)
    assert from_planes(got) == [ofn(*v) for v in zip(*(from_planes(a) for a in args))]


def test_mont_mul_unreduced_left_operand():
    """to_niels_xy multiplies raw 256-bit words by R^2: a >= p still gives
    the canonical a*R mod p."""
    rng = np.random.default_rng(5)
    a = to_planes(rand_elems(rng, N, bound=1 << 256))
    got = from_planes(planes_to_numpy(field_ops.to_mont(port(a))))
    assert got == [v * F.R % F.P for v in from_planes(a)]


@pytest.mark.parametrize("e", [0, 1, 2, 0b1011011, F.P - 2], ids=["0", "1", "2", "91", "p-2"])
def test_mont_pow_const_matches_jax_and_oracle(e):
    """(a*R) -> (a^e)*R digit for digit; 0 maps to 0 for e > 0. JAX runs
    its scan over the exponent bits as one compiled step."""
    rng = np.random.default_rng(e % 1000)
    vals = rand_elems(rng, 8)
    a = to_planes([v * F.R % F.P for v in vals])
    got = planes_to_numpy(field_ops.mont_pow_const(port(a), e))
    np.testing.assert_array_equal(got, jax_np(jfield.mont_pow_const(jax_digits(a), e)))
    assert from_planes(got) == [pow(v, e, F.P) * F.R % F.P for v in vals]


def test_finv_mont_matches_jax_and_oracle():
    rng = np.random.default_rng(17)
    vals = rand_elems(rng, 8)  # ends in 0, 1, p - 1
    a = to_planes([v * F.R % F.P for v in vals])
    got = planes_to_numpy(field_ops.finv_mont(port(a)))
    np.testing.assert_array_equal(got, jax_np(jfield.finv_mont(jax_digits(a))))
    want = [F.finv(v) * F.R % F.P if v else 0 for v in vals]
    assert from_planes(got) == want and want[-3] == 0


def rand_points(rng, n):
    """[4, 16, n] uint32 Montgomery planes of random field elements (the
    formulas' digits do not depend on the points being on the curve)."""
    return np.stack([to_planes(rand_elems(rng, n)) for _ in range(4)])


def jax_pts(st: np.ndarray):
    return jcurve.PointVec.from_stacked(jnp.asarray(st))


def port_pts(st: np.ndarray):
    return curve_ops.PointVec.from_stacked(port(st))


@pytest.mark.parametrize("name", ["add", "add_niels", "double", "select", "to_niels_from_xy",
                                  "to_niels_planes"])
def test_curve_op_matches_jax(name):
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    p, q = rand_points(rng, N), rand_points(rng, N)
    if name == "add":
        got = curve_ops.add(port_pts(p), port_pts(q)).stacked()
        want = jcurve.add(jax_pts(p), jax_pts(q)).stacked()
    elif name == "add_niels":
        got = curve_ops.add_niels(port_pts(p), port(q[0]), port(q[1]), port(q[2])).stacked()
        want = jcurve.add_niels(jax_pts(p), *(jax_digits(q[c]) for c in range(3))).stacked()
    elif name == "double":
        got = curve_ops.double(port_pts(p)).stacked()
        want = jcurve.double(jax_pts(p)).stacked()
    elif name == "select":
        mask = rng.integers(0, 2, N).astype(bool)
        got = curve_ops.select(torch.from_numpy(mask), port_pts(p), port_pts(q)).stacked()
        want = jcurve.select(jnp.asarray(mask), jax_pts(p), jax_pts(q)).stacked()
    elif name == "to_niels_planes":
        got = curve_ops.to_niels_planes(port(p[:3]))
        want = jcurve.to_niels_planes(jnp.asarray(p[:3]))
    else:
        got = curve_ops.to_niels_from_xy(port(p[0]), port(p[1]))
        want = jcurve.to_niels_from_xy(jnp.asarray(p[0]), jnp.asarray(p[1]))
    np.testing.assert_array_equal(planes_to_numpy(got), np.asarray(want))


def test_identity_matches_jax():
    got = curve_ops.identity((3, 5)).stacked()
    np.testing.assert_array_equal(planes_to_numpy(got), np.asarray(jcurve.identity((3, 5)).stacked()))


@pytest.mark.parametrize("w", [8, 12, 13, 16])
@pytest.mark.parametrize("signed", [False, True])
def test_split_windows_matches_jax(w, signed):
    rng = np.random.default_rng(w)
    words = rng.integers(0, 1 << 32, size=(8, 40), dtype=np.uint64).astype(np.uint32)
    words[7] &= (1 << 29) - 1  # signed digits need scalars < 2^254
    words[:, 0] = 0
    words[:, 1] = 0xFFFFFFFF  # every window at its top: the longest carry chain
    words[7, 1] = (1 << 29) - 1
    t = torch.from_numpy(words.astype(np.int64))
    if signed:
        b, s = windows.split_windows_signed(t, w)
        jb, js = jwindows.split_windows_signed(jnp.asarray(words), w)
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    else:
        got = windows.split_windows(t, w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jwindows.split_windows(jnp.asarray(words), w)))


def test_cuda_constants_match_oracle():
    """The limb constants written into field.cuh are p, R, 2R, R^2, 2d*R,
    2d*R^2 and -p^-1 mod 2^32, and there are no others."""
    src = (Path(__file__).resolve().parents[1]
           / "webgpu_msm_tpu_torch/ops/kernels/csrc/field.cuh").read_text()

    def limbs_of(name):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", src).group(1)
        vals = [int(v.strip().rstrip("u"), 16) for v in body.split(",")]
        return sum(v << (32 * i) for i, v in enumerate(vals))

    assert limbs_of("P_L") == F.P
    assert limbs_of("R_L") == F.R_MOD_P
    assert limbs_of("TWO_R_L") == 2 * F.R % F.P
    assert limbs_of("R2_L") == F.R2_MOD_P
    assert limbs_of("TWO_D_R_L") == 2 * F.EDWARDS_D * F.R % F.P
    assert limbs_of("TWO_D_R2_L") == 2 * F.EDWARDS_D * F.R2_MOD_P % F.P
    assert set(re.findall(r"__constant__ u32 (\w+)\[8\]", src)) == {
        "P_L", "R_L", "TWO_R_L", "R2_L", "TWO_D_R_L", "TWO_D_R2_L"}
    n0 = int(re.search(r"constexpr u32 N0 = (0x[0-9a-f]+)u;", src).group(1), 16)
    assert n0 == F.N0_INV_32
