"""The port's bucket reduction against the JAX package's, at every group size.

Gs > 1 runs the grouped form (`grouped_running_sum` over each group, then
`reduce_finish` over the groups with the doublings, the add and
`from_mont`), adding in the order of its kernels' tree; the JAX package's
grouped CPU fallback adds in another order, so window sums are compared as
affine points, and against the oracle's running sum. Gs 1 runs the suffix
scan `_suffix_weighted` in the JAX order, so it matches digit for digit.
The JAX functions run op by op under `jax.disable_jit()`: their XLA:CPU
compile takes minutes at any shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.ops import pippenger as jpip
from webgpu_msm_tpu.oracle import curve as oc
from webgpu_msm_tpu.oracle import field as F
from webgpu_msm_tpu.oracle import msm as omsm
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


def _running_sums(pts, n_buckets) -> list:
    """The oracle's sum_b b * S_b of each window of `pts` ([K * n_buckets])."""
    return [oc.to_affine(omsm.bucket_reduce(pts[k * n_buckets : (k + 1) * n_buckets])) for k in range(K)]


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
    assert got == _running_sums(pts, B)  # sum_b b * S_b by the serial running sum


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


B_RAGGED = 40  # not a power of two: the rolls wrap and the masks cut


@pytest.fixture(scope="module")
def ragged_buckets():
    pts = fixtures.distinct_points_fast(K * B_RAGGED, seed=98)
    pts[3], pts[B_RAGGED + 39] = oc.IDENTITY, oc.IDENTITY
    return pts, _planes(pts).reshape(4, 16, K, B_RAGGED)


@pytest.fixture(scope="module")
def jax_reduce(buckets, ragged_buckets, jax_window_sums):
    """Gs -> the JAX package's window sums [4, 16, K] (Montgomery): Gs 1 its
    `_suffix_weighted` over the ragged buckets (what its `reduce_buckets`
    returns at Gs 1), other Gs its `reduce_buckets(group_size=Gs)` over
    `buckets`; computed once each, on first use."""
    cache = {4: jax_window_sums}

    def get(Gs):
        if Gs not in cache:
            with jax.disable_jit():
                if Gs == 1:
                    cache[Gs] = np.asarray(jpip._suffix_weighted(jnp.asarray(ragged_buckets[1])))
                else:
                    cache[Gs] = np.asarray(jpip.reduce_buckets(jnp.asarray(buckets[1]), group_size=Gs))
        return cache[Gs]

    return get


@pytest.mark.parametrize("Gs", [1, 2, 4, 16])
def test_reduce_buckets_group_size_matches_jax(buckets, ragged_buckets, jax_reduce, Gs):
    """Gs 1 digit for digit against the JAX suffix scan (B 40); Gs 2, 4 and
    16 as points against `jpip.reduce_buckets(group_size=Gs)` (B 64), and
    every Gs against the oracle's running sum."""
    pts, bs = ragged_buckets if Gs == 1 else buckets
    got = pippenger.reduce_buckets(planes_from_numpy(bs), group_size=Gs)
    assert got.dtype == torch.int64 and got.shape == (4, 16, K)
    want = jax_reduce(Gs)
    if Gs == 1:
        np.testing.assert_array_equal(planes_to_numpy(got), want)
    assert _affine(planes_to_numpy(got)) == _affine(want) == _running_sums(pts, bs.shape[-1])


def test_suffix_weighted_matches_jax_digit_for_digit(ragged_buckets, jax_reduce):
    """The suffix scan alone, int32 in and out, over a batch of K windows."""
    got = pippenger._suffix_weighted(planes_from_numpy(ragged_buckets[1]))
    assert got.dtype == torch.int32 and got.shape == (4, 16, K) and got.is_contiguous()
    np.testing.assert_array_equal(planes_to_numpy(got), jax_reduce(1))


@pytest.mark.parametrize("n_buckets,rule", [(B_RAGGED, 1), (B, 16)])
def test_default_group_size_is_the_tpu_rule(buckets, ragged_buckets, n_buckets, rule):
    """group_size 0 takes `group_size(B)` (1 below 64 buckets, which used to
    raise), digit for digit, in both outputs of `reduce_and_finish`."""
    bs = planes_from_numpy((ragged_buckets if n_buckets == B_RAGGED else buckets)[1])
    assert pippenger.group_size(n_buckets) == rule
    default = pippenger.reduce_and_finish(bs)
    explicit = pippenger.reduce_and_finish(bs, group_size=rule)
    for a, b in zip(default, explicit):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    plain, mont = default
    want = torch.stack([field_ops.from_mont(mont[c].to(torch.int64)) for c in range(4)])
    assert torch.equal(plain.to(torch.int64), want)
    assert torch.equal(pippenger.reduce_buckets(bs), mont.to(torch.int64))


@pytest.mark.parametrize("n_buckets,Gs", [(B, 3), (B, 6), (B, 128), (B_RAGGED, 16)])
def test_group_size_must_be_a_power_of_two_dividing_b(buckets, ragged_buckets, n_buckets, Gs):
    """A difference kept on purpose: the JAX function asserts only that Gs
    divides B, and at Gs 3 doubles once (log2 rounded down) into a wrong
    sum; the port raises for any Gs that is not a power of two dividing B."""
    bs = planes_from_numpy((ragged_buckets if n_buckets == B_RAGGED else buckets)[1])
    with pytest.raises(ValueError, match="power of two dividing"):
        pippenger.reduce_buckets(bs, group_size=Gs)
    with pytest.raises(ValueError, match="power of two dividing"):
        pippenger.reduce_and_finish(bs, group_size=Gs)
