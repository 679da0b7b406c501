"""The device-resident single-batch plan: the port's `accumulate_and_reduce`
and `msm_window_sums` against the JAX package's, and `_device_msm` on
tensors under the device-resident rules.

One JAX pass for the whole file, op by op under `jax.disable_jit()`:
`accumulate_buckets` over two batches (w 8 signed, C 8 x L 8, n 128), then
`reduce_buckets` on its bucket sums. Together these two calls are the JAX
`accumulate_and_reduce`, split so that the bucket sums between them can be
held digit for digit. The first batch's `_accumulate_batch` (one batch, no
carry) is recorded on the way. The reductions add in another order, so
window sums are compared as points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.ops import pippenger as jpip

from webgpu_msm_tpu_torch import MSMConfig, compute_msm
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.ops import pippenger
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle import curve, field
from webgpu_msm_tpu_torch.oracle import msm as omsm
from webgpu_msm_tpu_torch.utils import convert, fixtures
from webgpu_msm_tpu_torch.utils.interop import affine_from_planes, planes_from_numpy, planes_to_numpy

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

W_, C_, L_, N = 8, 8, 8, 128  # two batches of C * L = 64
STATIC = dict(window_size=W_, n_chunks=C_, chunk_len=L_, signed_digits=True)


def combined(wsums_mont, w: int) -> tuple[int, int]:
    """Montgomery window sums [4, 16, K] -> the affine MSM result."""
    points = [curve.from_affine(*xy) for xy in affine_from_planes(planes_to_numpy(wsums_mont))]
    return curve.to_affine(omsm.combine_windows(points, w))


@pytest.fixture(scope="module")
def case():
    """128 distinct points as Montgomery Niels planes, scalars with the edge
    values, and the oracle's result."""
    pts = fixtures.distinct_points_fast(N, seed=41)
    sc = fixtures.random_scalars(N, seed=42)
    sc[:5] = [0, 1, (1 << 253) - 1, field.P - 1, 1 << (W_ - 1)]
    sc[64:96] = [sc[64]] * 32  # equal scalars: runs over several lanes in every window
    niels = pk.to_niels(planes_from_numpy(gpu_engine.marshal_points(pts, N)))
    words = gpu_engine.marshal_scalars(sc, N)
    return planes_to_numpy(niels), words, curve.to_affine(omsm.msm(pts, sc, W_))


@pytest.fixture(scope="module")
def jax_pass(case):
    """(the first batch's bucket sums, the two batches' bucket sums, the
    window sums), all Montgomery planes as numpy u32."""
    niels, words, _ = case
    first = []
    real = jpip._accumulate_batch
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jpip, "_accumulate_batch", lambda *a: first.append(real(*a)) or first[-1])
        bucket_sums = jpip.accumulate_buckets(jnp.asarray(niels), jnp.asarray(words), **STATIC)
        wsums = jpip.reduce_buckets(bucket_sums)
    assert len(first) == 2
    return np.asarray(first[0]), np.asarray(bucket_sums), np.asarray(wsums)


def test_accumulate_buckets_matches_jax(case, jax_pass):
    """Two batches, each added into an identity carry: digit for digit."""
    niels, words, _ = case
    got = pippenger.accumulate_buckets(planes_from_numpy(niels), torch.from_numpy(words.astype(np.int64)),
                                       **STATIC)
    assert got.shape == (4, 16, 32, pippenger.n_buckets(W_, True))
    np.testing.assert_array_equal(planes_to_numpy(got), jax_pass[1])


def test_single_batch_has_no_carry(case, jax_pass):
    """One batch adds into nothing, as the JAX `_accumulate_batch` does:
    `accumulate_buckets` over n = C * L and `accumulate_batch` with no
    carry give its digits (an identity carry would give others)."""
    niels, words, _ = case
    pts, sw = planes_from_numpy(niels[..., :64]), torch.from_numpy(words[:, :64].astype(np.int64))
    for got in (pippenger.accumulate_buckets(pts, sw, **STATIC), pippenger.accumulate_batch(pts, sw, **STATIC)):
        np.testing.assert_array_equal(planes_to_numpy(got), jax_pass[0])


@pytest.mark.parametrize("entry", ["accumulate_and_reduce", "msm_window_sums"])
def test_window_sums_match_jax_and_oracle(case, jax_pass, entry):
    """int32 words as the JAX entry takes them; window sums equal the JAX
    ones as points, and combine to the oracle's result."""
    niels, words, want = case
    got = getattr(pippenger, entry)(planes_from_numpy(niels), planes_from_numpy(words), **STATIC)
    assert got.dtype == torch.int64 and got.shape == (4, 16, 32)
    assert affine_from_planes(planes_to_numpy(got)) == affine_from_planes(jax_pass[2])
    assert combined(got, W_) == want


def test_resident_bucket_count_matches_oracle():
    """w 14 signed (B 8 224 buckets, K 19 windows) in one batch of C 16 x
    L 16, against the oracle. The resident w 16 (B 32 800) takes about a
    minute of plain PyTorch here and is held on the card instead
    (`test_torch_gpu.py`, `chip_smoke.py`)."""
    n, w = 256, 14
    pts = fixtures.distinct_points_fast(n, seed=43)
    sc = fixtures.random_scalars(n, seed=44)
    assert pippenger.n_buckets(w, True) == 8224 and pippenger.group_size(8224) == 32
    niels = pk.to_niels(planes_from_numpy(gpu_engine.marshal_points(pts, n)))
    got = pippenger.msm_window_sums(niels, planes_from_numpy(gpu_engine.marshal_scalars(sc, n)),
                                    window_size=w, n_chunks=16, chunk_len=16, signed_digits=True)
    assert combined(got, w) == curve.to_affine(omsm.msm(pts, sc, 8))


def test_device_msm_resident_rules_equal_wire_path(monkeypatch):
    """At 2^12 the device-resident rules give w 12 and one batch of C 256 x
    L 16; `_device_msm` on tensors slices nothing out of them (the batch is
    the whole input) and equals the wire path."""
    n = 1 << 12
    cfg = MSMConfig()
    w, (C, L) = cfg.resolved_window_size(n), cfg.resolved_chunking(n)
    assert (w, C, L) == (12, 256, 16)
    pts = fixtures.distinct_points_fast(n, seed=45)
    sc = fixtures.random_scalars(n, seed=46)
    planes = planes_from_numpy(gpu_engine.marshal_points(pts, n))
    words = planes_from_numpy(gpu_engine.marshal_scalars(sc, n))
    seen = []
    real = gpu_engine._batch_planes_impl
    monkeypatch.setattr(gpu_engine, "_batch_planes_impl",
                        lambda p, s, c, **kw: seen.append((p.data_ptr(), s.data_ptr())) or real(p, s, c, **kw))
    out = gpu_engine._device_msm(planes, words, window_size=w, n_chunks=C, chunk_len=L, signed_digits=True)
    assert seen == [(planes.data_ptr(), words.data_ptr())]
    got = curve.to_affine(omsm.combine_windows(gpu_engine.window_sums_to_points(out.numpy()), w))
    wire = compute_msm(fixtures.wire_points(pts), convert.bigints_to_u32_be(sc), device="cpu")
    assert got == (wire.x, wire.y)
