"""The port on the card: each CUDA kernel against its plain version, and
`compute_msm` (wire rows and lists) and `MSMPlan` against the port's own
oracle.

Every test here is marked `gpu` and skips without a CUDA device. The file
imports no JAX, because the GPU machine has none; run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py sets up JAX for the other files.)
"""
import numpy as np
import pytest
import torch

from webgpu_msm_tpu_torch import MSMConfig, MSMPlan, compute_msm
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle import curve, msm
from webgpu_msm_tpu_torch.utils import convert, fixtures
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_planes(rng, lead, width):
    """Random field elements below p as [*lead, 16, width] uint32 digits."""
    d = rng.integers(0, 1 << 16, size=lead + (16, width), dtype=np.uint32)
    d[..., 15, :] %= 0x12AB  # p's top digit is 0x12ab
    return d


def _inputs(name, rng, dev, width=300):
    t = lambda arr: planes_from_numpy(arr, dev)
    if name == "to_niels_xy":
        return (t(rand_planes(rng, (2,), width)),)
    if name == "to_niels":
        return (t(rand_planes(rng, (3,), width)),)
    if name in ("accumulate_scan", "accumulate_scan_mma"):
        L = 12
        ids = np.sort(rng.integers(0, 40, size=(width, L)), axis=1).T.astype(np.uint32)
        ids |= rng.integers(0, 2, size=(L, width)).astype(np.uint32) << 31
        niels = rand_planes(rng, (3,), L * width).reshape(3, 16, L, width)
        return (t(niels[:, 0::2] | (niels[:, 1::2] << 16)), t(ids))
    if name == "padd_masked":
        return (t(rand_planes(rng, (4,), width)), t(rand_planes(rng, (4,), width)),
                t(rng.integers(0, 2, size=width).astype(np.uint32)))
    if name == "padd":
        return (t(rand_planes(rng, (4,), width)), t(rand_planes(rng, (4,), width)))
    return (t(rand_planes(rng, (5, 4), width)),)


def _kernel_and_plain(name):
    if name == "accumulate_scan_mma":
        return (lambda p, i: pk.accumulate_scan(p, i, use_mma=True),
                lambda p, i: pk.accumulate_scan_plain(p, i, use_mma=True))
    return getattr(pk, name), getattr(pk, name + "_plain")


@pytest.mark.parametrize("name", pk.KERNELS)
def test_kernel_matches_plain_on_card(cuda, name):
    """Every kernel at a ragged width (300 lanes: the last warp is partly
    beyond the width) against its plain version on the same tensors."""
    args = _inputs(name, np.random.default_rng(10), cuda)
    kernel, plain = _kernel_and_plain(name)
    before = dict(pk.launches)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert pk.launches == {**before, name: before[name] + 1}
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g, w)


def test_compute_msm_on_card_matches_oracle(cuda):
    pts = fixtures.distinct_points_fast(48, seed=51)
    scalars = fixtures.random_scalars(48, seed=52)
    want = curve.to_affine(msm.msm(pts, scalars, 8))
    pk.reset_launch_counts()
    got = compute_msm(
        fixtures.wire_points(pts), convert.bigints_to_u32_be(scalars),
        config=MSMConfig(window_size=8, n_chunks=4, chunk_len=4), device=cuda,
    )
    assert (got.x, got.y) == want
    assert all(pk.launches[name] > 0 for name in pk.KERNELS[:5]), pk.launches
    assert pk.launches["to_niels"] == pk.launches["accumulate_scan_mma"] == 0


def test_tensor_core_scan_equals_cios_scan_on_card(cuda):
    args = _inputs("accumulate_scan", np.random.default_rng(11), cuda, width=2049)
    for a, b in zip(pk.accumulate_scan(*args), pk.accumulate_scan(*args, use_mma=True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device_affine", [False, True])
def test_list_input_on_card_matches_oracle(cuda, device_affine):
    """Lists take the planes path: `to_niels`, never `to_niels_xy`."""
    pts = fixtures.distinct_points_fast(48, seed=53)
    scalars = fixtures.random_scalars(48, seed=54)
    pk.reset_launch_counts()
    got = compute_msm(pts, scalars, device=cuda, config=MSMConfig(
        window_size=8, n_chunks=4, chunk_len=4, device_affine=device_affine))
    assert (got.x, got.y) == curve.to_affine(msm.msm(pts, scalars, 8))
    assert pk.launches["to_niels"] == 3 and pk.launches["to_niels_xy"] == 0


def test_msm_plan_on_card_matches_oracle(cuda):
    pts = fixtures.distinct_points_fast(48, seed=55)
    jobs = [fixtures.random_scalars(48, seed=56 + j) for j in range(2)]
    pk.reset_launch_counts()
    plan = MSMPlan(fixtures.wire_points(pts), device=cuda,
                   config=MSMConfig(window_size=8, n_chunks=4, chunk_len=4))
    assert pk.launches["to_niels_xy"] == 3
    got = plan.msm_batch([convert.bigints_to_u32_be(jobs[0]), jobs[1]])
    assert [(r.x, r.y) for r in got] == [curve.to_affine(msm.msm(pts, sc, 8)) for sc in jobs]
    assert pk.launches["to_niels_xy"] == 3 and pk.launches["accumulate_scan"] == 6
