"""The batch stage's last two kernels through their plain versions, against
the JAX package digit for digit: `lane_scan` (the segmented scan over each
window's lanes) and `assemble_buckets` (the carry pick, the bucket add and
the batch carry add).

The JAX side is restated from `_accumulate_batch` (ops/pippenger.py: the
seg_level loop, and the bucket assembly after the histogram) over the
package's own `_roll_pts`, `_vadd_masked` and `_vadd`, run op by op under
`jax.disable_jit()`, where they take the `curve_ops` path. The tolerance is
zero. On the card the kernels are held against these plain versions by
tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.ops import curve_ops as jcurve
from webgpu_msm_tpu.ops import pippenger as jp

from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy, planes_to_numpy

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)


def rand_planes(rng, lead, width):
    d = rng.integers(0, 1 << 16, size=lead + (16, width), dtype=np.uint32)
    d[..., 15, :] %= 0x12AB  # below p
    return d


# ---- lane_scan -------------------------------------------------------------

def lane_ids(pattern: str, K: int, C: int, rng) -> np.ndarray:
    """[K * C] sorted final ids along each window's lanes."""
    rows = []
    for k in range(K):
        if pattern == "one segment over every lane":
            row = [7 + k] * C
        elif pattern == "segments of 2-7 lanes":
            row, bucket = [], int(rng.integers(0, 4))
            while len(row) < C:
                row += [bucket] * int(rng.integers(2, 8))
                bucket += int(rng.integers(1, 4))
            row = row[:C]
        else:  # all distinct
            row = list(np.cumsum(rng.integers(1, 5, size=C)))
        rows.append(row)
    return np.array(rows, dtype=np.uint32).reshape(K * C)


def jax_seg_levels(final_acc: np.ndarray, final_id: np.ndarray, K: int, C: int) -> np.ndarray:
    """The seg_level loop of the JAX `_accumulate_batch`, level by level."""
    carry = jnp.asarray(final_acc).reshape(4, 16, K, C)
    ids = jnp.asarray(final_id).reshape(K, C)
    lane_idx = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32), (K, C))
    with jax.disable_jit():
        for i in range(max((C - 1).bit_length(), 1)):
            d = 1 << i
            shifted = jp._roll_pts(carry, d, axis=-1)
            ok = (lane_idx >= d) & (jnp.roll(ids, d, axis=-1) == ids)
            carry = jp._vadd_masked(carry, shifted, ok)
    return np.asarray(carry).reshape(4, 16, K * C)


@pytest.mark.parametrize("C", [1, 5, 16])
@pytest.mark.parametrize("pattern", ["one segment over every lane", "segments of 2-7 lanes",
                                     "all distinct"])
def test_lane_scan_plain_matches_jax_seg_levels(pattern, C):
    K = 3
    rng = np.random.default_rng(C * 31 + len(pattern))
    final_acc = rand_planes(rng, (4,), K * C)
    final_id = lane_ids(pattern, K, C, rng)
    got = pk.lane_scan(planes_from_numpy(final_acc), planes_from_numpy(final_id), K)
    assert got.dtype == torch.int32 and got.shape == (4, 16, K * C)
    np.testing.assert_array_equal(planes_to_numpy(got), jax_seg_levels(final_acc, final_id, K, C))
    if pattern == "one segment over every lane" and C > 1:
        # Every lane added at every level it could: the last lane is no
        # longer its own value.
        assert not (planes_to_numpy(got)[..., C - 1] == final_acc[..., C - 1]).all()


def test_lane_scan_rejects_bad_arguments_and_does_not_count():
    acc = planes_from_numpy(rand_planes(np.random.default_rng(1), (4,), 6))
    ids = planes_from_numpy(np.zeros(6, dtype=np.uint32))
    pk.reset_launch_counts()
    pk.lane_scan(acc, ids, 2)
    assert pk.launches == {name: 0 for name in pk.KERNELS}
    with pytest.raises(ValueError):
        pk.lane_scan(acc, ids, 4)  # 6 lanes, 4 windows
    with pytest.raises(ValueError):
        pk.lane_scan(acc, ids[:5].contiguous(), 2)
    with pytest.raises(TypeError):
        pk.lane_scan(acc, ids.to(torch.int64), 2)


# ---- assemble_buckets -----------------------------------------------------------

K_, C_, L_, B_ = 2, 4, 4, 8

# Sorted bucket ids of one window's C * L = 16 points (lane c holds sorted
# positions 4c .. 4c + 3).
WINDOWS = {
    "runs crossing lane edges": [1] * 6 + [2] * 5 + [5] * 5,
    "runs ending exactly on lane edges": [0] * 4 + [3] * 8 + [4] * 4,
    "empty buckets between singles": [0, 1, 2, 3, 4, 5, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7],
    "one bucket fills the window": [6] * 16,
}


def hist_and_ends(first: str, second: str):
    """hist [K, B] and e_pos [K, B] (first sorted index past each bucket)."""
    hist = np.stack([np.bincount(WINDOWS[w], minlength=B_) for w in (first, second)]).astype(np.uint32)
    return hist, np.cumsum(hist, axis=1).astype(np.uint32)


def jax_assemble(partial, carries, hist, e_pos, carry):
    """Lines 360-385 of the JAX `_accumulate_batch` from `e_pos` on, with
    `partial` as the staged half, then the engines' `_vadd(carry, .)`."""
    C, L = C_, L_
    hist, e_pos = jnp.asarray(hist.astype(np.int32)), jnp.asarray(e_pos.astype(np.int32))
    with jax.disable_jit():
        s_pos = e_pos - hist
        c0 = s_pos // L
        c_last = e_pos // L - 1
        carry_valid = c_last >= c0
        c_last_c = jnp.clip(c_last, 0, C - 1)
        k_idx = jax.lax.broadcasted_iota(jnp.int32, (K_, B_), 0)
        carry_idx = (k_idx * C + c_last_c).reshape(-1)
        carry_pts = jnp.take(jnp.asarray(carries), carry_idx, axis=-1).reshape(4, 16, K_, B_)
        id_kb = jcurve.identity((K_, B_)).stacked()
        b_st = jnp.where(carry_valid[None, None], carry_pts, id_kb)
        out = jp._vadd(jnp.asarray(partial).reshape(4, 16, K_, B_), b_st)
        if carry is not None:
            out = jp._vadd(jnp.asarray(carry).reshape(4, 16, K_, B_), out)
    return np.asarray(out).reshape(4, 16, K_ * B_)


@pytest.mark.parametrize("with_carry", [False, True], ids=["bucket sums", "carry + bucket sums"])
@pytest.mark.parametrize("first,second", [
    ("runs crossing lane edges", "runs ending exactly on lane edges"),
    ("empty buckets between singles", "one bucket fills the window"),
])
def test_assemble_buckets_plain_matches_jax(first, second, with_carry):
    rng = np.random.default_rng(len(first) + 2 * len(second) + with_carry)
    partial = rand_planes(rng, (4,), K_ * B_)
    carries = rand_planes(rng, (4,), K_ * C_)
    carry = rand_planes(rng, (4,), K_ * B_) if with_carry else None
    hist, e_pos = hist_and_ends(first, second)
    t = planes_from_numpy
    got = pk.assemble_buckets(t(partial), t(carries), t(hist), t(e_pos), L_,
                              None if carry is None else t(carry))
    assert got.dtype == torch.int32 and got.shape == (4, 16, K_ * B_)
    np.testing.assert_array_equal(planes_to_numpy(got), jax_assemble(partial, carries, hist, e_pos, carry))


def test_assemble_buckets_picks_the_lanes_a_run_covers():
    """Which buckets take a lane total: a run that reaches a lane edge takes
    the lane before its last edge; a run inside a lane, an empty bucket, or
    one that starts on an edge and ends inside the next lane takes the
    identity. With partial the identity, bucket (k, b) is identity + its
    pick, digit for digit."""
    hist, e_pos = hist_and_ends("runs crossing lane edges", "runs ending exactly on lane edges")
    ident = pk.identity_planes((K_ * B_,), "cpu")
    carries = planes_from_numpy(rand_planes(np.random.default_rng(3), (4,), K_ * C_))
    got = pk.assemble_buckets_plain(ident, carries, planes_from_numpy(hist),
                                    planes_from_numpy(e_pos), L_)
    # Window 1: bucket 1 covers lane 0 and ends in lane 1, bucket 2 covers
    # lane 1 and ends in lane 2, bucket 5 ends on the window's last edge.
    # Window 2: bucket 0 fills lane 0, bucket 3 lanes 1-2, bucket 4 lane 3.
    picks = {(0, 1): 0, (0, 2): 1, (0, 5): 3, (1, 0): 0, (1, 3): 2, (1, 4): 3}
    want = ident.clone()
    for (k, b), lane in picks.items():
        want[..., k * B_ + b] = carries[..., k * C_ + lane]
    assert torch.equal(got, pk.padd_plain(ident, want))


@pytest.mark.parametrize("bad", ["partial width", "e_pos shape", "carry width", "windows"])
def test_assemble_buckets_rejects_bad_arguments(bad):
    rng = np.random.default_rng(4)
    t = planes_from_numpy
    args = dict(partial=t(rand_planes(rng, (4,), K_ * B_)), carries=t(rand_planes(rng, (4,), K_ * C_)),
                hist=t(np.ones((K_, B_), dtype=np.uint32)), e_pos=t(np.ones((K_, B_), dtype=np.uint32)),
                chunk_len=L_, carry=t(rand_planes(rng, (4,), K_ * B_)))
    if bad == "partial width":
        args["partial"] = args["partial"][..., 1:].contiguous()
    elif bad == "e_pos shape":
        args["e_pos"] = args["e_pos"][:1].contiguous()
    elif bad == "carry width":
        args["carry"] = args["carry"][..., 1:].contiguous()
    else:  # 7 lanes do not split into 2 windows
        args["carries"] = args["carries"][..., 1:].contiguous()
    with pytest.raises(ValueError):
        pk.assemble_buckets(**args)
