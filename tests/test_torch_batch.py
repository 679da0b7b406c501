"""The port's batch stage against the JAX package's, digit for digit.

The batch stage (`_wire_batch_impl`: BE unpack, Niels conversion, window
split, sorted accumulation, lane scan, bucket assembly, carry add) must
give the JAX stage's bucket carry, unsigned and signed.

The JAX stage runs op by op under `jax.disable_jit()`: the same integer
operations as the engine's jitted stage, without its XLA:CPU compile
(about 95 s per stage on the development host, against about 30 s here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
import pytest

from webgpu_msm_tpu.engines import tpu_engine as te
from webgpu_msm_tpu.oracle import field as F
from webgpu_msm_tpu.utils import convert, fixtures

from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.ops import pippenger
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy, planes_to_numpy

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

W_, C_, L_ = 8, 8, 8
M = C_ * L_


@pytest.fixture(scope="module")
def wire_batch():
    """64 points of BE x||y and scalar rows. Scalars 0..39 are equal, so in
    every window one bucket's run spans several lanes."""
    pts = fixtures.distinct_points_fast(M, seed=71)
    sc = fixtures.random_scalars(M, seed=72)
    sc[:40] = [sc[0]] * 40
    sc[40:44] = [0, 1, (1 << 253) - 1, F.P - 1]
    xy = np.concatenate(
        [convert.bigints_to_u32_be([p.x for p in pts]), convert.bigints_to_u32_be([p.y for p in pts])],
        axis=1,
    )
    return xy, convert.bigints_to_u32_be(sc)


def test_wire_niels_matches_jax(wire_batch):
    xy, _ = wire_batch
    got = planes_to_numpy(gpu_engine._wire_niels(planes_from_numpy(xy)))
    np.testing.assert_array_equal(got, np.asarray(te._wire_niels(jnp.asarray(xy))))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_wire_batch_carry_matches_jax(wire_batch, signed):
    """The incoming carry holds random field elements, so the carry add
    is checked on every bucket, not only on identities."""
    xy, sc = wire_batch
    K, B = -(-256 // W_), pippenger.n_buckets(W_, signed)
    rng = np.random.default_rng(73 + signed)
    carry = rng.integers(0, 1 << 16, size=(4, 16, K, B), dtype=np.uint32)
    carry[:, 15] %= 0x12AB  # below p
    with jax.disable_jit():
        want = te._wire_batch_impl(
            jnp.asarray(xy), jnp.asarray(sc), jnp.asarray(carry), window_size=W_,
            n_chunks=C_, chunk_len=L_, signed_digits=signed,
        )
    got = gpu_engine._wire_batch_impl(
        planes_from_numpy(xy), planes_from_numpy(sc), planes_from_numpy(carry),
        window_size=W_, n_chunks=C_, chunk_len=L_, signed_digits=signed,
    )
    np.testing.assert_array_equal(planes_to_numpy(got), np.asarray(want))
