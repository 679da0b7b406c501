"""The port's plain digit planes against the JAX package's: host
marshalling, the planes batch stage and the device-resident entry, and
`compute_msm` on every input form that the API marshals to wire rows
(the affine finish is in test_torch_affine.py).

The JAX stages run op by op under `jax.disable_jit()` (the same integer
operations as the jitted stages, without minutes of XLA:CPU compile).
All comparisons are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webgpu_msm_tpu as jm
from webgpu_msm_tpu import api as japi
from webgpu_msm_tpu import config as jconfig
from webgpu_msm_tpu.engines import tpu_engine as te
from webgpu_msm_tpu.oracle import curve as joc
from webgpu_msm_tpu.oracle import field as F
from webgpu_msm_tpu.oracle import msm as jmsm

import webgpu_msm_tpu_torch as tm
from webgpu_msm_tpu_torch import MSMConfig
from webgpu_msm_tpu_torch import api
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.ops import pippenger
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle.curve import ExtPoint
from webgpu_msm_tpu_torch.utils import convert, fixtures
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy, planes_to_numpy

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

N, W_, C_, L_ = 16, 8, 4, 4
STATIC = dict(window_size=W_, n_chunks=C_, chunk_len=L_)
CFG = MSMConfig(**STATIC)


def coords(points) -> list:
    """ExtPoints of either package as plain tuples."""
    return [(p.x, p.y, p.t, p.z) for p in points]


def jax_points(points) -> list:
    """The port's ExtPoints as the JAX package's."""
    return [joc.ExtPoint(*c) for c in coords(points)]


def scaled(p: ExtPoint, lam: int) -> ExtPoint:
    """The same point with z = lam."""
    return ExtPoint(p.x * lam % F.P, p.y * lam % F.P, p.t * lam % F.P, lam)


@pytest.fixture(scope="module")
def case():
    """16 distinct points, three of them with z != 1, and scalars with
    the edge values; the oracle's result."""
    pts = fixtures.distinct_points_fast(N, seed=81)
    pts[3], pts[7], pts[8] = scaled(pts[3], 5), scaled(pts[7], F.P - 2), scaled(pts[8], 1 << 200)
    sc = fixtures.random_scalars(N, seed=82)
    sc[:4] = [0, 1, (1 << 253) - 1, F.P - 1]
    return pts, sc, joc.to_affine(jmsm.msm(pts, sc, 8))


# ---- host marshalling ------------------------------------------------------

@pytest.mark.parametrize("pad_to", [N, 24])
def test_marshal_matches_jax(case, pad_to):
    pts, sc, _ = case
    planes = gpu_engine.marshal_points(pts, pad_to)
    assert planes.dtype == np.uint32 and planes.shape == (3, 16, pad_to)
    np.testing.assert_array_equal(planes, te.marshal_points(jax_points(pts), pad_to))
    words = gpu_engine.marshal_scalars(sc, pad_to)
    assert words.dtype == np.uint32 and words.shape == (8, pad_to)
    np.testing.assert_array_equal(words, te.marshal_scalars(sc, pad_to))
    # a z != 1 point is normalized to its affine x, y and t = x*y
    x, y = joc.to_affine(pts[7])
    got = [sum(int(planes[c, k, 7]) << (16 * k) for k in range(16)) for c in range(3)]
    assert got == [x, y, x * y % F.P]


def test_convert_helpers_match_jax(case):
    from webgpu_msm_tpu.utils import convert as jconvert

    _, sc, _ = case
    vals = sc + [(1 << 256) - 1]
    np.testing.assert_array_equal(convert.bigints_to_words_le(vals), jconvert.bigints_to_words_le(vals))
    be = convert.bigints_to_u32_be(vals)
    assert convert.u32_be_to_bigints(be) == jconvert.u32_be_to_bigints(be) == vals
    with pytest.raises(ValueError, match="u32"):
        convert.u32_be_to_bigints(be.astype(np.int64) + (1 << 32))


@pytest.mark.parametrize("signed_digits", [True, False])
def test_signed_ok_matches_jax(case, signed_digits):
    _, sc, _ = case
    small = gpu_engine.marshal_scalars(sc, N)
    big = gpu_engine.marshal_scalars(sc[:-1] + [1 << 254], N)
    for words in (small, big):
        got = gpu_engine._signed_ok(MSMConfig(signed_digits=signed_digits), words)
        assert got is te._signed_ok(jconfig.MSMConfig(signed_digits=signed_digits), words)
    assert gpu_engine._signed_ok(MSMConfig(), small) and not gpu_engine._signed_ok(MSMConfig(), big)


# ---- stages ----------------------------------------------------------------

def rand_carry(seed, signed):
    K, B = -(-256 // W_), pippenger.n_buckets(W_, signed)
    carry = np.random.default_rng(seed).integers(0, 1 << 16, size=(4, 16, K, B), dtype=np.uint32)
    carry[:, 15] %= 0x12AB  # below p
    return carry


def test_batch_planes_carry_matches_jax(case):
    """Signed digits, a random incoming carry: carry for carry."""
    pts, sc, _ = case
    planes, words = gpu_engine.marshal_points(pts, N), gpu_engine.marshal_scalars(sc, N)
    carry = rand_carry(83, True)
    with jax.disable_jit():
        want = te._batch_planes_impl(jnp.asarray(planes), jnp.asarray(words), jnp.asarray(carry),
                                     signed_digits=True, **STATIC)
    got = gpu_engine._batch_planes_impl(
        planes_from_numpy(planes), planes_from_numpy(words), planes_from_numpy(carry),
        signed_digits=True, **STATIC)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(planes_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_batch_planes_equals_wire_batch(case, signed):
    """The planes stage and the wire stage (held against the JAX one in
    test_torch_batch.py) give one carry for the same affine points."""
    pts, sc, _ = case
    aff = [ExtPoint(*joc.to_affine(p), 0, 1) for p in pts]
    aff = [ExtPoint(p.x, p.y, p.x * p.y % F.P, 1) for p in aff]
    planes, words = gpu_engine.marshal_points(aff, N), gpu_engine.marshal_scalars(sc, N)
    carry = planes_from_numpy(rand_carry(84, signed))
    got = gpu_engine._batch_planes_impl(planes_from_numpy(planes), planes_from_numpy(words), carry,
                                        signed_digits=signed, **STATIC)
    xy = fixtures.wire_points(aff)[:, :16]
    want = gpu_engine._wire_batch_impl(planes_from_numpy(xy), planes_from_numpy(convert.bigints_to_u32_be(sc)),
                                       carry, signed_digits=signed, **STATIC)
    assert torch.equal(got, want)


def test_accumulate_buckets_loops_over_batches(case):
    """Two batches through `accumulate_buckets` = the two `accumulate_batch`
    results added, and `identity_buckets` is the JAX identity carry."""
    pts, sc, _ = case
    niels = pk.to_niels(planes_from_numpy(gpu_engine.marshal_points(pts, N)))
    words = torch.from_numpy(gpu_engine.marshal_scalars(sc, N).astype(np.int64))
    kw = dict(window_size=W_, n_chunks=2, chunk_len=4, signed_digits=True)
    got = pippenger.accumulate_buckets(niels, words, **kw)
    halves = [pippenger.accumulate_batch(niels[..., s].contiguous(), words[:, s], **kw)
              for s in (slice(0, 8), slice(8, 16))]
    ident = pippenger.identity_buckets(W_, True)
    np.testing.assert_array_equal(planes_to_numpy(ident), np.asarray(te._identity_carry(W_, True)))
    add = lambda a, b: pk.padd(a.reshape(4, 16, -1), b.reshape(4, 16, -1)).reshape(a.shape)
    want = add(add(ident, halves[0]), halves[1])
    assert torch.equal(got, want)


def test_device_msm_takes_device_tensors(case):
    """Tensors are sliced where they lie, here over two batches; the same
    lists through `compute_msm` (marshalled to wire rows) give the same
    point."""
    pts, sc, want = case
    planes, words = gpu_engine.marshal_points(pts, N), gpu_engine.marshal_scalars(sc, N)
    kw = dict(window_size=W_, n_chunks=2, chunk_len=4, signed_digits=True)
    out = gpu_engine._device_msm(planes_from_numpy(planes), planes_from_numpy(words), **kw)
    assert out.shape == (4, 16, 32)
    wsums = gpu_engine.window_sums_to_points(out.numpy())
    assert joc.to_affine(jmsm.combine_windows(wsums, W_)) == want
    got = tm.compute_msm(pts, sc, config=MSMConfig(**{**STATIC, "n_chunks": 2}), device="cpu")
    assert (got.x, got.y) == want


# ---- compute_msm on every form that the API marshals to wire rows ----------

def forms(pts, sc):
    """Input form -> (points, scalars), all of the same MSM."""
    wire = fixtures.wire_points(pts)  # rows 3, 7 and 8 have z != 1
    be = convert.bigints_to_u32_be(sc)
    return {
        "ext-points": (pts, sc),
        "xyzt-tuples": ([(p.x, p.y, p.t, p.z) for p in pts], sc),
        "dict-of-arrays": ({c: wire[:, 8 * i : 8 * i + 8] for i, c in enumerate("xytz")}, list(be)),
        "per-point-dicts": ([dict(x=p.x, y=p.y, t=p.t, z=p.z) for p in pts], be),
        "wire-rows-z-not-1": (wire, be),
        "wire-rows-list-scalars": (wire, sc),
    }


FORMS = ["ext-points", "xyzt-tuples", "dict-of-arrays", "per-point-dicts", "wire-rows-z-not-1",
         "wire-rows-list-scalars"]


@pytest.mark.parametrize("form", FORMS)
def test_normalization_matches_jax(case, form):
    pts, sc, _ = case
    p, s = forms(pts, sc)[form]
    jp = jax_points(p) if form == "ext-points" else p
    assert coords(api._normalize_points(p)) == coords(japi._normalize_points(jp)) == coords(pts)
    assert api._normalize_scalars(s) == japi._normalize_scalars(s) == sc
    if isinstance(p, np.ndarray) and isinstance(s, np.ndarray):  # z != 1: marshalled, not taken as it is
        assert api._wire_fast_path_ok(p, s) is japi._wire_fast_path_ok(p, s) is False


@pytest.mark.parametrize("device_affine", [False, True], ids=["extended", "device-affine"])
@pytest.mark.parametrize("form", FORMS)
def test_compute_msm_forms_match_oracle(case, form, device_affine, monkeypatch):
    """Every form is marshalled to wire rows and takes the wire road (one
    `to_niels_xy_rows` a batch; never `to_niels` or `to_niels_xy`), and
    gives the oracle's point."""
    pts, sc, want = case
    calls = []
    for name in ("to_niels", "to_niels_xy", "to_niels_xy_rows"):
        monkeypatch.setattr(pk, name, lambda t, _f=getattr(pk, name), _n=name: (calls.append(_n), _f(t))[1])
    p, s = forms(pts, sc)[form]
    got = tm.compute_msm(p, s, config=MSMConfig(device_affine=device_affine, **STATIC), device="cpu")
    assert (got.x, got.y) == want and calls == ["to_niels_xy_rows"]


def test_xy_tuples(case):
    pts, sc, _ = case
    aff = [joc.to_affine(p) for p in pts[:9]]
    got = tm.compute_msm(aff, sc[:9], config=CFG, device="cpu")
    assert (got.x, got.y) == joc.to_affine(jmsm.msm(pts[:9], sc[:9], 8))


def test_compute_msm_lists_match_jax(case):
    """The JAX `compute_msm` on its planes path, op by op, against the
    port's on the marshalled wire rows: one affine point, equal to the
    oracle's. (The JAX package
    normalizes every other form to these lists, as the port does:
    test_normalization_matches_jax.)"""
    pts, sc, want = case
    with jax.disable_jit():
        ref = jm.compute_msm(jax_points(pts), sc, config=jconfig.MSMConfig(**STATIC), engine="tpu")
    got = tm.compute_msm(pts, sc, config=CFG, device="cpu")
    assert (got.x, got.y) == (ref.x, ref.y) == want
