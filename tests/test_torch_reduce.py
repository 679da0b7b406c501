"""The port's grouped bucket reduction against the JAX package's.

The port always runs the grouped form (`grouped_running_sum` over each
group, then `reduce_finish` over the groups with the doublings, the add and
`from_mont`), adding in the order of its kernels' tree; the JAX package's
grouped CPU fallback adds in another order, so window sums are compared as
affine points, and against the oracle's running sum. The JAX function runs op by op under
`jax.disable_jit()`: its XLA:CPU compile takes minutes at any shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.ops import pippenger as jpip
from webgpu_msm_tpu.oracle import curve as oc
from webgpu_msm_tpu.oracle import field as F
from webgpu_msm_tpu.utils import fixtures

from webgpu_msm_tpu_torch.ops import field_ops, pippenger
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.utils.interop import affine_from_planes, planes_from_numpy, planes_to_numpy

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

K, B = 2, 64


def _planes(points) -> np.ndarray:
    """ExtPoints -> [4, 16, n] uint32 Montgomery digit planes."""
    out = np.zeros((4, 16, len(points)), dtype=np.uint32)
    for i, p in enumerate(points):
        for c, v in enumerate((p.x, p.y, p.t, p.z)):
            m = F.to_mont(v)
            out[c, :, i] = [(m >> (16 * d)) & 0xFFFF for d in range(16)]
    return out


def _affine(st) -> list:
    """[4, 16, K] Montgomery planes -> K affine points."""
    st = np.asarray(st, dtype=np.uint64)
    return [
        oc.to_affine(oc.ExtPoint(*(
            F.from_mont(sum(int(st[c, d, k]) << (16 * d) for d in range(16))) for c in range(4)
        )))
        for k in range(st.shape[-1])
    ]


@pytest.fixture(scope="module")
def buckets():
    pts = fixtures.distinct_points_fast(K * B, seed=97)
    pts[5], pts[B + 17] = oc.IDENTITY, oc.IDENTITY  # empty buckets
    return pts, _planes(pts).reshape(4, 16, K, B)


@pytest.fixture(scope="module")
def jax_window_sums(buckets):
    """The JAX package's window sums [4, 16, K], Montgomery domain, from its
    grouped CPU fallback at groups of 4: op by op, its cost follows the
    number of point adds, about 21 here against 45 at groups of 16."""
    with jax.disable_jit():
        return np.asarray(jpip.reduce_buckets(jnp.asarray(buckets[1]), group_size=4))


def test_grouped_reduce_matches_jax_and_oracle(buckets, jax_window_sums):
    pts, bs = buckets
    assert pippenger.group_size(B) == 16
    got = _affine(planes_to_numpy(pippenger.reduce_buckets(planes_from_numpy(bs))))
    assert got == _affine(jax_window_sums)
    for k in range(K):  # sum_b b * S_b by the serial running sum
        total = carry = oc.IDENTITY
        for b in range(B - 1, 0, -1):
            carry = oc.add(carry, pts[k * B + b])
            total = oc.add(total, carry)
        assert got[k] == oc.to_affine(total)


@pytest.mark.parametrize("Gs", [16, 8, 4])
def test_reduce_finish_plain_matches_jax_reduce_and_from_mont(buckets, jax_window_sums, Gs):
    """`reduce_finish` after the first grouped pass against the JAX
    package's `reduce_buckets` + the oracle's `from_mont`, as affine points.
    The window sums do not depend on the group size, so the JAX sums at
    groups of 4 hold the port's at groups of 16, 8 and 4 (4, 8 and 16
    groups a window; 4, 3 and 2 doublings)."""
    bs = planes_from_numpy(buckets[1])
    G = B // Gs
    s = bs.reshape(4, 16, K * G, Gs).permute(3, 0, 1, 2).contiguous()
    T, U = pk.grouped_running_sum(s)
    plain, mont = pk.reduce_finish(T, U, K, Gs.bit_length() - 1)
    assert plain.dtype == mont.dtype == torch.int32 and plain.shape == mont.shape == (4, 16, K)
    want = _affine(jax_window_sums)
    assert affine_from_planes(planes_to_numpy(plain), mont=False) == want
    assert _affine(planes_to_numpy(mont)) == want


def test_reduce_and_finish_outputs_agree(buckets):
    """The plain-domain output is `from_mont` of the Montgomery-domain one,
    digit for digit, and `reduce_buckets` is the latter."""
    bs = planes_from_numpy(buckets[1])
    plain, mont = pippenger.reduce_and_finish(bs)
    want = torch.stack([field_ops.from_mont(mont[c].to(torch.int64)) for c in range(4)])
    assert torch.equal(plain.to(torch.int64), want)
    assert torch.equal(pippenger.reduce_buckets(bs), mont.to(torch.int64))
