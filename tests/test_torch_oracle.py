"""The port's copies of the oracle, the fixtures and the small digit-plane
helpers against the JAX package's originals, on the same seeded inputs.

The port keeps its own copy of every such module (it imports nothing of
the JAX package); each name here must give what the original gives: the
pinned vectors digit for digit, the same field and curve answers, the same
test cases, and fixture files written byte for byte alike and readable by
either package.
"""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webgpu_msm_tpu.oracle as joracle
from webgpu_msm_tpu.ops import curve_ops as jcurve
from webgpu_msm_tpu.ops import field_ops as jfield
from webgpu_msm_tpu.ops import limbs as jlimbs
from webgpu_msm_tpu.oracle import curve as jc
from webgpu_msm_tpu.oracle import field as jF
from webgpu_msm_tpu.oracle import msm as jmsm
from webgpu_msm_tpu.oracle import testdata as jtd
from webgpu_msm_tpu.utils import convert as jconvert
from webgpu_msm_tpu.utils import fixtures as jfix

import webgpu_msm_tpu_torch.oracle as oracle
from webgpu_msm_tpu_torch.ops import curve_ops, field_ops, limbs
from webgpu_msm_tpu_torch.oracle import curve as tc
from webgpu_msm_tpu_torch.oracle import field as tF
from webgpu_msm_tpu_torch.oracle import msm as tmsm
from webgpu_msm_tpu_torch.oracle import testdata as ttd
from webgpu_msm_tpu_torch.utils import convert, fixtures
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

# Constants that JAX op modules import from the oracle for their own use.
IMPORTED_CONSTANTS = {"N0_INV_256", "P", "R", "R_MOD_P"}
MODULES = ("oracle.field", "oracle.curve", "oracle.msm", "oracle.testdata", "utils.fixtures",
           "utils.convert", "ops.limbs", "ops.field_ops", "ops.curve_ops")


def _defined_names(mod) -> set:
    """Public functions and classes defined in `mod`, and its public
    constants (imported modules, typing helpers and dtypes left out)."""
    out = set()
    for k, v in vars(mod).items():
        if k.startswith("_") or inspect.ismodule(v):
            continue
        if callable(v) and getattr(v, "__module__", None) != mod.__name__:
            continue
        if not callable(v) and not isinstance(v, (int, str, list, tuple, dict)):
            continue
        out.add(k)
    return out


@pytest.mark.parametrize("name", MODULES)
def test_module_defines_every_name_of_the_jax_module(name):
    j = importlib.import_module("webgpu_msm_tpu." + name)
    t = importlib.import_module("webgpu_msm_tpu_torch." + name)
    assert _defined_names(j) - _defined_names(t) - IMPORTED_CONSTANTS == set()


def test_oracle_package_reexports_the_jax_names():
    public = lambda m: {k for k in vars(m) if not k.startswith("_")}
    assert public(joracle) <= public(oracle)
    assert oracle.msm is tmsm and oracle.msm.msm is tmsm.msm


def _rng_ints(seed: int, n: int, bound: int = jF.P) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n)]


def _points(seed: int, n: int) -> list:
    """n seeded subgroup points (k * B), the same ExtPoints for both oracles."""
    b = ttd.base_point()
    return [tc.scalar_mul(b, k) for k in _rng_ints(seed, n, jF.SUBGROUP_ORDER)]


def _j(p):
    return jc.ExtPoint(p.x, p.y, p.t, p.z)


def test_pinned_vectors_are_the_jax_ones_digit_for_digit():
    assert ttd.SCALAR_MUL_VECTORS == jtd.SCALAR_MUL_VECTORS
    assert ttd.POINT_FROM_X_VECTORS == jtd.POINT_FROM_X_VECTORS
    assert (ttd.BASE_POINT_X, ttd.BASE_POINT_Y, ttd.BASE_POINT_T) == (
        jtd.BASE_POINT_X, jtd.BASE_POINT_Y, jtd.BASE_POINT_T)
    for name in ("P", "EDWARDS_A", "EDWARDS_D", "SUBGROUP_ORDER", "R_BITS", "R", "R_MOD_P", "R2_MOD_P",
                 "R_INV_MOD_P", "N0_INV_16", "N0_INV_32", "N0_INV_256"):
        assert getattr(tF, name) == getattr(jF, name), name


@pytest.mark.parametrize("i", range(len(ttd.SCALAR_MUL_VECTORS)))
def test_scalar_mul_vectors(i):
    (x, y), k, want = ttd.SCALAR_MUL_VECTORS[i]
    p = tc.from_affine(x, y)
    assert tc.is_on_curve(p)
    assert tc.to_affine(tc.scalar_mul(p, k)) == want == jc.to_affine(jc.scalar_mul(_j(p), k))


@pytest.mark.parametrize("i", range(len(ttd.POINT_FROM_X_VECTORS)))
def test_point_from_x_vectors(i):
    x, y = ttd.POINT_FROM_X_VECTORS[i]
    p = ttd.point_from_x(x)
    assert tc.to_affine(p) == (x, y)
    assert p == tc.ExtPoint(*vars(jtd.point_from_x(x)).values())


def test_fsqrt_mont_and_inverse_match_jax():
    vals = _rng_ints(1, 40) + [0, 1, jF.P - 1]
    roots = [tF.fsqrt(v) for v in vals]
    assert roots == [jF.fsqrt(v) for v in vals]
    assert any(r is None for r in roots) and any(r is not None for r in roots)
    for v, r in zip(vals, roots):
        if r is not None:
            assert r * r % tF.P == v % tF.P
    for v, w in zip(vals, vals[1:]):
        assert tF.to_mont(v) == jF.to_mont(v) and tF.from_mont(v) == jF.from_mont(v)
        assert tF.mont_mul(v, w) == jF.mont_mul(v, w)
        assert tF.from_mont(tF.mont_mul(tF.to_mont(v), tF.to_mont(w))) == tF.fmul(v, w)


def test_is_on_curve_eq_and_neg_match_jax():
    pts = _points(2, 6)
    off = [tc.ExtPoint(p.x, tF.fadd(p.y, 1), p.t, p.z) for p in pts[:3]]  # off the curve
    scaled = [tc.ExtPoint(*(tF.fmul(c, 7) for c in (p.x, p.y, p.t, p.z))) for p in pts]  # z = 7
    for p in pts + off + scaled + [tc.IDENTITY]:
        assert tc.is_on_curve(p) == jc.is_on_curve(_j(p))
        n = tc.neg(p)
        assert n == tc.ExtPoint(*vars(jc.neg(_j(p))).values())
        assert tc.eq(tc.add(p, n), tc.IDENTITY) == jc.eq(jc.add(_j(p), _j(n)), jc.IDENTITY)
    assert [tc.is_on_curve(p) for p in off] == [False] * 3
    for p, q in zip(pts, scaled):
        assert tc.eq(p, q) and jc.eq(_j(p), _j(q)) and p != q
        assert not tc.eq(p, tc.neg(p)) and not jc.eq(_j(p), jc.neg(_j(p)))


@pytest.mark.parametrize("w", [4, 13])
def test_split_scalar_bucket_accumulate_and_reduce_match_jax(w):
    scalars = _rng_ints(3, 8) + [0, (1 << 256) - 1]
    assert [tmsm.split_scalar(s, w) for s in scalars] == [jmsm.split_scalar(s, w) for s in scalars]
    for s in scalars:
        assert sum(d << (k * w) for k, d in enumerate(tmsm.split_scalar(s, w))) == s
    pts = _points(4, len(scalars))
    digits = [tmsm.split_scalar(s, w)[0] for s in scalars]
    nb = min(1 << w, 32)
    digits = [d % nb for d in digits]
    got = tmsm.bucket_accumulate(digits, pts, nb)
    want = jmsm.bucket_accumulate(digits, [_j(p) for p in pts], nb)
    assert [tuple(vars(p).values()) for p in got] == [tuple(vars(p).values()) for p in want]
    assert tuple(vars(tmsm.bucket_reduce(got)).values()) == tuple(vars(jmsm.bucket_reduce(want)).values())


def test_msm_naive_matches_jax_and_msm():
    pts, scalars = _points(5, 6), _rng_ints(6, 6)
    got = tmsm.msm_naive(pts, scalars)
    assert tuple(vars(got).values()) == tuple(vars(jmsm.msm_naive([_j(p) for p in pts], scalars)).values())
    assert tc.to_affine(got) == tc.to_affine(tmsm.msm(pts, scalars, 8))


def _case_equal(t, j) -> bool:
    return (t.scalars == j.scalars and t.expected == j.expected
            and [tuple(vars(p).values()) for p in t.points] == [tuple(vars(p).values()) for p in j.points])


@pytest.mark.parametrize("n,seed", [(1, 0), (64, 5)])
def test_repeated_base_case_matches_jax(n, seed):
    case = fixtures.repeated_base_case(n, seed=seed)
    assert _case_equal(case, jfix.repeated_base_case(n, seed=seed))
    assert tc.to_affine(tmsm.msm_naive(case.points, case.scalars)) == case.expected


@pytest.mark.parametrize("n,seed,w", [(3, 1, 13), (16, 7, 8)])
def test_distinct_case_matches_jax(n, seed, w):
    case = fixtures.distinct_case(n, seed=seed, window_size=w)
    assert _case_equal(case, jfix.distinct_case(n, seed=seed, window_size=w))
    assert len({(p.x, p.y) for p in case.points}) == n
    assert all(p.z == 1 and p.t == p.x * p.y % tF.P and tc.is_on_curve(p) for p in case.points)
    assert tc.to_affine(tmsm.msm_naive(case.points, case.scalars)) == case.expected


@pytest.mark.parametrize("bits", [253, 128, 256])
def test_random_scalars_bits_matches_jax(bits):
    got = fixtures.random_scalars(50, seed=9, bits=bits)
    assert got == jfix.random_scalars(50, seed=9, bits=bits) == fixtures.random_scalars(50, seed=9)
    assert all(0 <= s < tF.P for s in got)


def test_points_to_words_le_matches_jax():
    pts = _points(10, 5)
    cols = [[getattr(p, c) for p in pts] for c in "xytz"]
    got = convert.points_to_words_le(*cols)
    want = jconvert.points_to_words_le(*cols)
    assert got.dtype == want.dtype == np.uint32 and got.shape == (4, 8, 5)
    np.testing.assert_array_equal(got, want)
    assert convert.SCALAR_BITS == jconvert.SCALAR_BITS == 256
    assert convert.words_le_to_bigints(got[1]) == cols[1]


def test_fixture_files_written_alike_and_read_by_either_package(tmp_path):
    case = fixtures.distinct_case(5, seed=3, window_size=8)
    paths = {pkg: (tmp_path / f"{pkg}_points.txt", tmp_path / f"{pkg}_scalars.txt") for pkg in ("jax", "port")}
    fixtures.save_test_case(case, *paths["port"])
    jfix.save_test_case(jfix.distinct_case(5, seed=3, window_size=8), *paths["jax"])
    for port_file, jax_file in zip(paths["port"], paths["jax"]):
        assert port_file.read_bytes() == jax_file.read_bytes()
    # The port reads the JAX files and computes `expected` with its oracle
    # (w 13); the JAX package reads the port's files with `expected` given.
    back = fixtures.load_test_case(*paths["jax"])
    assert _case_equal(back, case)
    jback = jfix.load_test_case(*paths["port"], expected=case.expected)
    assert _case_equal(case, jback)


# ---- the digit-plane helpers on the port's int64 planes -------------------

def _planes(vals) -> np.ndarray:
    return np.array([[(v >> (16 * k)) & 0xFFFF for v in vals] for k in range(16)], np.uint32)


def _port(a: np.ndarray) -> torch.Tensor:
    return limbs.as_i64(planes_from_numpy(a))


def _jnp(digits) -> np.ndarray:
    return np.asarray(jnp.stack(list(digits)))


def test_to_words_le_stack_unstack_match_jax():
    a = _planes(_rng_ints(11, 20, 1 << 256)).reshape(16, 4, 5)
    got = limbs.to_words_le(_port(a))
    want = np.asarray(jlimbs.to_words_le(jlimbs.unstack(jnp.asarray(a))))
    assert got.shape == (8, 4, 5)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(limbs.from_words_le(got).numpy(), a.astype(np.int64))
    parts = limbs.unstack(_port(a))
    assert len(parts) == 16 and torch.equal(parts[3], _port(a)[3])
    assert torch.equal(limbs.stack(parts), _port(a))
    np.testing.assert_array_equal(np.asarray(jlimbs.stack(jlimbs.unstack(jnp.asarray(a)))), a)


@pytest.mark.parametrize("c", [0, 1, jF.P, (1 << 256) - 1, 0xFFFF << 64])
def test_sub_const_with_borrow_matches_jax(c):
    vals = _rng_ints(12, 20, 1 << 256) + [0, c, (c + 1) % (1 << 256)]
    a = _planes(vals)
    d, borrow = limbs.sub_const_with_borrow(_port(a), c)
    jd, jborrow = jlimbs.sub_const_with_borrow(jlimbs.unstack(jnp.asarray(a)), c)
    np.testing.assert_array_equal(d.numpy(), _jnp(jd).astype(np.int64))
    np.testing.assert_array_equal(borrow.numpy(), np.asarray(jborrow).astype(np.int64))
    assert borrow.tolist() == [int(v < c) for v in vals]


def test_field_double_matches_jax():
    vals = _rng_ints(13, 21) + [0, 1, jF.P - 1]
    a = _planes(vals)
    got = field_ops.field_double(_port(a))
    np.testing.assert_array_equal(got.numpy(), _jnp(jfield.field_double(jlimbs.unstack(jnp.asarray(a)))))
    assert [sum(int(got[k, i]) << (16 * k) for k in range(16)) for i in range(len(vals))] == [
        2 * v % jF.P for v in vals]


def test_curve_to_mont_and_from_mont_match_jax():
    pts = _points(14, 6) + [tc.IDENTITY]
    plain = np.stack([_planes([getattr(p, c) for p in pts]) for c in "xytz"])  # [4, 16, n]
    mont = curve_ops.to_mont(curve_ops.PointVec.from_stacked(_port(plain)))
    jmont = jcurve.to_mont(jcurve.PointVec.from_stacked(jnp.asarray(plain)))
    np.testing.assert_array_equal(mont.stacked().numpy(), np.asarray(jmont.stacked()))
    for c, coord in enumerate("xytz"):
        assert [sum(int(mont[c][k, i]) << (16 * k) for k in range(16)) for i in range(len(pts))] == [
            tF.to_mont(getattr(p, coord)) for p in pts]
    back = curve_ops.from_mont(mont)
    np.testing.assert_array_equal(back.stacked().numpy(), np.asarray(jcurve.from_mont(jmont).stacked()))
    np.testing.assert_array_equal(back.stacked().numpy(), plain.astype(np.int64))
