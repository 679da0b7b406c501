"""The port's naive and baseline engines against the JAX package's, on the
CPU: their ladders' pieces digit for digit (`add_mixed`, the tree sum
`_tree_sum_axis`, the baseline's 16-bit ladder), the baseline's host
bucketing, and both engines whole against the JAX oracle.

The JAX pieces are jitted in their package; here they run op by op under
`jax.disable_jit()`, with the same integer operations and no XLA:CPU
compile. The JAX naive engine itself is not called: its 256-step ladder
compiles for minutes on XLA:CPU (the JAX package's own test of it is
`slow`). All comparisons are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.engines import baseline_engine as jbaseline
from webgpu_msm_tpu.ops import curve_ops as jcurve
from webgpu_msm_tpu.ops import limbs as jlimbs
from webgpu_msm_tpu.ops import pippenger as jpippenger
from webgpu_msm_tpu.oracle import msm as jmsm

import webgpu_msm_tpu_torch as tm
from webgpu_msm_tpu_torch.engines import baseline_engine, gpu_engine
from webgpu_msm_tpu_torch.ops import curve_ops, pippenger
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle import curve, field
from webgpu_msm_tpu_torch.oracle.curve import ExtPoint
from webgpu_msm_tpu_torch.utils import fixtures
from webgpu_msm_tpu_torch.utils.interop import mont_planes_from_points, planes_from_numpy

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)


def xy(res):
    return (res.x, res.y)


def mont_points(n, seed):
    """[4, 16, n] Montgomery planes of n curve points with random z != 1."""
    rng = np.random.default_rng(seed)
    pts = []
    for p in fixtures.distinct_points_fast(n, seed=seed):
        z = int(rng.integers(2, 1 << 62))
        pts.append(ExtPoint(p.x * z % field.P, p.y * z % field.P, p.t * z % field.P, z))
    return mont_planes_from_points(pts)


def count_calls(monkeypatch, mod, name):
    """Record the first argument's shape of every call of mod.name."""
    calls, real = [], getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    return calls


# ---- naive -----------------------------------------------------------------

def test_add_mixed_matches_jax():
    acc = mont_points(8, seed=61)
    aff = mont_planes_from_points(fixtures.distinct_points_fast(8, seed=62))[:3]
    with jax.disable_jit():
        ref = jcurve.add_mixed(jcurve.PointVec.from_stacked(jnp.asarray(acc)),
                               *(jlimbs.unstack(jnp.asarray(c)) for c in aff)).stacked()
    got = curve_ops.add_mixed(curve_ops.PointVec.from_stacked(torch.from_numpy(acc.astype(np.int64))),
                              *(torch.from_numpy(c.astype(np.int64)) for c in aff)).stacked()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("G", [8, 5])
def test_tree_sum_axis_matches_jax(G, monkeypatch):
    """Digit for digit, one `padd_masked` a level."""
    K = 2
    st = mont_points(K * G, seed=70 + G).reshape(4, 16, K, G)
    with jax.disable_jit():
        ref = np.asarray(jpippenger._tree_sum_axis(jnp.asarray(st)))
    calls = count_calls(monkeypatch, pk, "padd_masked")
    got = pippenger._tree_sum_axis(torch.from_numpy(st.astype(np.int64)))
    assert got.shape == (4, 16, K)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert calls == [(4, 16, K * G)] * (G - 1).bit_length()


def test_naive_engine_matches_jax_oracle(monkeypatch):
    """Full 256-bit scalars (0, 1 and 2^256 - 1 among them); the tree sum
    over pad_to = 128 lanes is 7 `padd_masked` levels."""
    pts = fixtures.distinct_points_fast(8, seed=31)
    scalars = fixtures.random_scalars(8, seed=32)
    scalars[:3] = [0, 1, (1 << 256) - 1]
    want = curve.to_affine(jmsm.msm(pts, scalars, 8))
    calls = count_calls(monkeypatch, pk, "padd_masked")
    got = tm.compute_msm(pts, scalars, device="cpu", engine="naive")
    assert xy(got) == want
    assert calls == [(4, 16, 128)] * 7


# ---- baseline --------------------------------------------------------------

@pytest.fixture(scope="module")
def collision_case():
    """8 points, scalars with a forced collision in window 0."""
    pts = fixtures.distinct_points_fast(8, seed=41)
    scalars = fixtures.random_scalars(8, seed=42)
    scalars[1] = (scalars[1] & ~0xFFFF) | (scalars[0] & 0xFFFF)
    return pts, scalars, curve.to_affine(jmsm.msm(pts, scalars, 8))


def test_host_bucket_entries_match_jax(collision_case):
    pts, scalars, _ = collision_case
    got = baseline_engine._host_bucket_entries(pts, scalars)
    ref = jbaseline._host_bucket_entries(pts, scalars)
    coords = lambda entries: [(w, d, (p.x, p.y, p.t, p.z)) for w, d, p in entries]
    assert coords(got) == coords(ref)
    assert any(w == 0 and p.z != 1 for w, _, p in got)  # the collision was added on the host


class _EagerLax:
    """`jax.lax` whose `fori_loop` hands its body a jnp index, as the traced
    loop does (under `disable_jit` it hands a Python int, which the JAX
    ladder's `j.astype` rejects)."""

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    @staticmethod
    def fori_loop(lower, upper, body, init):
        for j in range(lower, upper):
            init = body(jnp.int32(j), init)
        return init


def test_device_mul_16bit_matches_jax(monkeypatch):
    pts = fixtures.distinct_points_fast(8, seed=43)
    planes = gpu_engine.marshal_points(pts, 8)
    small = np.array([0, 1, 2, 3, 0xFFFF, 0x8000, 12345, 54321], dtype=np.uint32)
    monkeypatch.setattr(jbaseline, "lax", _EagerLax())
    with jax.disable_jit():
        ref = np.asarray(jbaseline._device_mul_16bit(jnp.asarray(planes), jnp.asarray(small)))
    got = baseline_engine._device_mul_16bit(planes_from_numpy(planes), planes_from_numpy(small))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_baseline_engine_matches_jax_oracle(collision_case):
    pts, scalars, want = collision_case
    assert xy(tm.compute_msm(pts, scalars, device="cpu", engine="baseline")) == want
    assert tm.compute_msm(pts, [0] * 8, device="cpu", engine="baseline") == tm.AffinePoint(0, 1)


