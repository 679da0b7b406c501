"""`device_affine` against the JAX package: the `finish_affine_divsteps`
kernel's plain version, the affine finish stage, and the wire `compute_msm` with
the z inverse on the device.

The JAX side runs op by op under `jax.disable_jit()` (the same integer
operations as its jitted stages, without minutes of XLA:CPU compile);
only the Fermat inverse keeps its compiled scan step, since 253 steps op
by op would take minutes. All comparisons are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webgpu_msm_tpu as jm
from webgpu_msm_tpu import config as jconfig
from webgpu_msm_tpu.engines import tpu_engine as te
from webgpu_msm_tpu.ops import field_ops as jfield
from webgpu_msm_tpu.ops import limbs as jlimbs
from webgpu_msm_tpu.oracle import curve as joc
from webgpu_msm_tpu.oracle import field as F
from webgpu_msm_tpu.oracle import msm as jmsm

import webgpu_msm_tpu_torch as tm
from webgpu_msm_tpu_torch import MSMConfig
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.utils import convert, fixtures
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy, planes_to_numpy

from torch_inputs import mont_window_sums
from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

STATIC = dict(window_size=8, n_chunks=4, chunk_len=4)


def coords(points) -> list:
    """ExtPoints of either package as plain tuples."""
    return [(p.x, p.y, p.t, p.z) for p in points]


def jax_unjitted_but_for_the_inverse(monkeypatch):
    """Inside `jax.disable_jit()`, let `finv_mont` compile its scan step."""
    orig = jfield.finv_mont

    def finv(a):
        with jax.disable_jit(False):
            return orig(a)

    monkeypatch.setattr(jfield, "finv_mont", finv)
    return jax.disable_jit()


def bucket_planes(points, K, B) -> np.ndarray:
    """ExtPoints -> [4, 16, K, B] uint32 Montgomery bucket planes."""
    out = np.zeros((4, 16, len(points)), dtype=np.uint32)
    for i, p in enumerate(points):
        for c, v in enumerate((p.x, p.y, p.t, p.z)):
            m = F.to_mont(v)
            out[c, :, i] = [(m >> (16 * d)) & 0xFFFF for d in range(16)]
    return out.reshape(4, 16, K, B)


def test_finish_affine_plain_matches_the_jax_chain(monkeypatch):
    """`finish_affine_plain` at K 16 (the resident call's windows) and K 20
    (the wire call's), digit for digit against the JAX `finv_mont`,
    `mont_mul` and `from_mont`: both widths in one JAX inverse of 36 lanes,
    so its scan compiles once. A z = 0 lane gives (0, 0), as there."""
    rng = np.random.default_rng(88)
    sums = [mont_window_sums(rng, K) for K in (16, 20)]
    got = np.concatenate([planes_to_numpy(pk.finish_affine_plain(planes_from_numpy(s))) for s in sums], -1)
    both = jnp.asarray(np.concatenate(sums, -1))
    with jax_unjitted_but_for_the_inverse(monkeypatch):
        zi = jfield.finv_mont(jlimbs.unstack(both[3]))
        want = np.stack([np.asarray(jlimbs.stack(jfield.from_mont(jfield.mont_mul(jlimbs.unstack(both[c]), zi))))
                         for c in (0, 1)])
    assert got.shape == (2, 16, 36)
    np.testing.assert_array_equal(got, want)
    assert not got[:, :, [1, 17]].any()


def test_finish_affine_on_cpu_tensors_runs_the_plain_version_uncounted():
    mont = planes_from_numpy(mont_window_sums(np.random.default_rng(89), 3))
    pk.reset_launch_counts()
    got = pk.finish_affine_divsteps(mont)
    assert torch.equal(got, pk.finish_affine_plain(mont)) and got.dtype == torch.int32
    assert pk.launches == {name: 0 for name in pk.KERNELS}
    with pytest.raises(ValueError, match="finish_affine_divsteps"):
        pk.finish_affine_divsteps(mont[:3].contiguous())


def test_finish_affine_matches_jax_and_oracle(monkeypatch):
    """Affine window sums are canonical, so the port's grouped reduction
    and the JAX package's must agree digit for digit; bucket 0 of window 1
    is left empty (the identity)."""
    K, B = 2, 64
    pts = fixtures.distinct_points_fast(K * B, seed=85)
    pts[B] = joc.IDENTITY
    bs = bucket_planes(pts, K, B)
    got = planes_to_numpy(gpu_engine._finish_affine_impl(planes_from_numpy(bs)))
    assert got.shape == (2, 16, K)
    with jax_unjitted_but_for_the_inverse(monkeypatch):
        want = te._finish_affine_impl(jnp.asarray(bs))
    np.testing.assert_array_equal(got, np.asarray(want))
    wsums = gpu_engine.window_sums_to_points(got.astype(np.int64))
    assert coords(wsums) == coords(te.window_sums_to_points(np.asarray(want)))
    for k in range(K):  # sum_b b * S_b by the serial running sum
        total = carry = joc.IDENTITY
        for b in range(B - 1, 0, -1):
            carry = joc.add(carry, pts[k * B + b])
            total = joc.add(total, carry)
        assert (wsums[k].x, wsums[k].y) == joc.to_affine(total) and wsums[k].z == 1
    assert gpu_engine._call_finish(planes_from_numpy(bs), 6, False, True).shape == (2, 16, K)
    assert gpu_engine._call_finish(planes_from_numpy(bs), 6, False, False).shape == (4, 16, K)


def test_device_affine_compute_msm_matches_jax_and_oracle(monkeypatch):
    """The wire call with `device_affine`, JAX against the port."""
    pts = fixtures.distinct_points_fast(16, seed=86)
    sc = fixtures.random_scalars(16, seed=87)
    want = joc.to_affine(jmsm.msm(pts, sc, 8))
    pw, sw = fixtures.wire_points(pts), convert.bigints_to_u32_be(sc)
    with jax_unjitted_but_for_the_inverse(monkeypatch):
        ref = jm.compute_msm(pw, sw, config=jconfig.MSMConfig(device_affine=True, **STATIC),
                             engine="tpu")
    got = tm.compute_msm(pw, sw, config=MSMConfig(device_affine=True, **STATIC), device="cpu")
    assert (got.x, got.y) == (ref.x, ref.y) == want
