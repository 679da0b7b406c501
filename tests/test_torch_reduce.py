"""The port's grouped bucket reduction against the JAX package's.

The port always runs the grouped form (two `grouped_running_sum` passes,
then doublings and one add); the JAX package's grouped CPU fallback adds
in another order, so window sums are compared as affine points, and
against the oracle's running sum. The JAX function runs op by op under
`jax.disable_jit()`: its XLA:CPU compile takes minutes at any shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from webgpu_msm_tpu.ops import pippenger as jpip
from webgpu_msm_tpu.oracle import curve as oc
from webgpu_msm_tpu.oracle import field as F
from webgpu_msm_tpu.utils import fixtures

from webgpu_msm_tpu_torch.ops import pippenger
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy, planes_to_numpy

# The tensors here are tiny: extra intra-op threads only contend with the
# other test workers.
torch.set_num_threads(1)

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


def test_grouped_reduce_matches_jax_and_oracle():
    pts = fixtures.distinct_points_fast(K * B, seed=97)
    bs = _planes(pts).reshape(4, 16, K, B)
    assert pippenger.group_size(B) == 16
    got = _affine(planes_to_numpy(pippenger.reduce_buckets(planes_from_numpy(bs))))
    with jax.disable_jit():
        want = _affine(jpip.reduce_buckets(jnp.asarray(bs), group_size=16))
    assert got == want
    for k in range(K):  # sum_b b * S_b by the serial running sum
        total = carry = oc.IDENTITY
        for b in range(B - 1, 0, -1):
            carry = oc.add(carry, pts[k * B + b])
            total = oc.add(total, carry)
        assert got[k] == oc.to_affine(total)
