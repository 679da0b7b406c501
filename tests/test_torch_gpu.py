"""The port on the card: each CUDA kernel against its plain version, and
`compute_msm` against the port's own oracle.

Every test here is marked `gpu` and skips without a CUDA device. The file
imports no JAX, because the GPU machine has none; run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py sets up JAX for the other files.)
"""
import numpy as np
import pytest
import torch

from webgpu_msm_tpu_torch import MSMConfig, compute_msm
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
    if name == "accumulate_scan":
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


@pytest.mark.parametrize("name", pk.KERNELS)
def test_kernel_matches_plain_on_card(cuda, name):
    args = _inputs(name, np.random.default_rng(10), cuda)
    before = pk.launches[name]
    got = getattr(pk, name)(*args)
    torch.cuda.synchronize()
    assert pk.launches[name] == before + 1
    want = getattr(pk, name + "_plain")(*args)
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
    assert all(pk.launches[name] > 0 for name in pk.KERNELS), pk.launches
