"""The two kernels redesigned for the H100, through their plain versions:
the scan that gathers its own rows and writes bucket partial sums
(`accumulate_scan_gather`), and the tree reduction (`grouped_running_sum`;
`reduce_finish` has its own tests, tests/test_torch_reduce_finish.py).

The scan is held digit for digit against the dense pipeline it replaces
(row gather, `accumulate_scan_plain`, a select of the staged accumulators);
the tree against a serial chain of the oracle's adds as points, because it
adds in another order and extended coordinates are not canonical. On the
card the kernels are held against these plain versions by
tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.oracle import curve as oc
from webgpu_msm_tpu.utils import fixtures

from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.utils.interop import (
    affine_from_planes, mont_planes_from_points, planes_from_numpy, planes_to_numpy)

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

S = 1 << 31  # sign flag
K, C, L, B = 2, 4, 4, 8
M, W = C * L, K * C

# Sorted bucket ids of one window's M = 16 points; lane c holds positions
# 4c .. 4c + 3.
WINDOWS = {
    "runs crossing lane edges": [1] * 6 + [2] * 5 + [5] * 5,
    "a run ending exactly at a lane edge": [0] * 4 + [3] * 6 + [4] * 6,
    "empty buckets between singles": [0, 1, 2, 3, 4, 5, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7],
    "one bucket fills the window": [6] * 16,
    "a run over three lanes": [2] + [3] * 11 + [7] * 4,
}


def rand_planes(rng, lead, width):
    d = rng.integers(0, 1 << 16, size=lead + (16, width), dtype=np.uint32)
    d[..., 15, :] %= 0x12AB
    return d


def scan_inputs(rng, first: str, second: str):
    """rows [M, 24], perm [L, W], ids [L, W] for two windows with the given
    sorted ids, random signs and a random order of the points."""
    niels = rand_planes(rng, (3,), M)
    rows = (niels[:, 0::2] | (niels[:, 1::2] << 16)).reshape(24, M).T.copy()
    perm = np.stack([rng.permutation(M) for _ in range(K)]).astype(np.uint32)  # [K, M]
    ids = np.array([WINDOWS[first], WINDOWS[second]], dtype=np.uint32)
    ids |= rng.integers(0, 2, size=(K, M)).astype(np.uint32) << 31
    lanes = lambda a: a.reshape(K, C, L).transpose(2, 0, 1).reshape(L, W).copy()
    return rows, lanes(perm), lanes(ids)


@pytest.mark.parametrize("first,second", [
    ("runs crossing lane edges", "a run ending exactly at a lane edge"),
    ("empty buckets between singles", "one bucket fills the window"),
    ("a run over three lanes", "runs crossing lane edges"),
])
def test_accumulate_scan_gather_plain_matches_dense_pipeline(first, second):
    """final_acc and final_id are the dense scan's on the gathered rows, and
    partial holds, for every bucket whose run ends at a step l > 0 of a lane
    (the id changes there), the accumulator staged before that step; the
    identity for every other bucket: empty ones, and runs ending at a lane
    edge or at the window's end."""
    rng = np.random.default_rng(len(first) + len(second))
    rows, perm, ids = scan_inputs(rng, first, second)
    t = planes_from_numpy
    facc, fid, partial = pk.accumulate_scan_gather(t(rows), t(perm), t(ids), K, B)

    gathered = rows[perm.reshape(-1)].T.reshape(3, 8, L, W).copy()
    want_acc, want_id, staged = pk.accumulate_scan_plain(t(gathered), t(ids))
    assert torch.equal(facc, want_acc) and torch.equal(fid, want_id)
    want = planes_to_numpy(pk.identity_planes((K, B), "cpu"))
    staged, masked = planes_to_numpy(staged), ids & 0x7FFFFFFF
    written = set()
    for w in range(W):
        for l in range(1, L):
            if masked[l, w] != masked[l - 1, w]:
                bucket = (w // C, int(masked[l - 1, w]))
                assert bucket not in written  # one writer a bucket
                written.add(bucket)
                want[:, :, bucket[0], bucket[1]] = staged[:, :, l, w]
    np.testing.assert_array_equal(planes_to_numpy(partial).reshape(4, 16, K, B), want)
    # What the patterns promise: partial sums were written, and the bucket
    # that ends at a lane edge (window 2 of the first case) was not.
    assert written
    if second == "a run ending exactly at a lane edge":
        assert (1, 0) not in written and (1, 3) in written


def test_accumulate_scan_gather_sentinel_and_first_step():
    """Step 0 never writes: the scan's id starts at the sentinel, which is
    no bucket, even where the first id of a lane is bucket 0 or differs from
    every other."""
    rng = np.random.default_rng(5)
    rows, perm, ids = scan_inputs(rng, "empty buckets between singles", "one bucket fills the window")
    _, fid, partial = pk.accumulate_scan_gather_plain(
        planes_from_numpy(rows), planes_from_numpy(perm), planes_from_numpy(ids), K, B)
    partial = planes_to_numpy(partial).reshape(4, 16, K, B)
    ident = planes_to_numpy(pk.identity_planes((), "cpu"))
    # Window 2 is one run: nothing ends inside a lane.
    assert all((partial[:, :, 1, b] == ident).all() for b in range(B))
    # Window 1: buckets 0..2 and 4..6 end inside lanes 0 and 1; bucket 3 ends at a lane edge.
    ended = [not (partial[:, :, 0, b] == ident).all() for b in range(B)]
    assert ended == [True, True, True, False, True, True, True, False]
    assert planes_to_numpy(fid).tolist() == [3, 7, 7, 7, 6, 6, 6, 6]


def test_accumulate_scan_gather_rejects_bad_shapes_and_does_not_count():
    rows, perm, ids = (planes_from_numpy(a) for a in scan_inputs(
        np.random.default_rng(6), "one bucket fills the window", "one bucket fills the window"))
    pk.reset_launch_counts()
    pk.accumulate_scan_gather(rows, perm, ids, K, B)
    assert pk.launches == {name: 0 for name in pk.KERNELS}
    with pytest.raises(ValueError):
        pk.accumulate_scan_gather(rows[:, :23].contiguous(), perm, ids, K, B)
    with pytest.raises(ValueError):
        pk.accumulate_scan_gather(rows, perm[:2].contiguous(), ids, K, B)
    with pytest.raises(ValueError):
        pk.accumulate_scan_gather(rows, perm, ids, 3, B)  # 8 lanes, 3 windows


# ---- the tree reduction ------------------------------------------------------

def serial_sums(points):
    """T = sum_r s_r and U = sum_r r * s_r by the serial chain, as affine."""
    run = u = oc.IDENTITY
    for i, p in enumerate(reversed(points)):
        run = oc.add(run, p)
        if i != len(points) - 1:
            u = oc.add(u, run)
    return oc.to_affine(run), oc.to_affine(u)


@pytest.mark.parametrize("Gs,threads", [
    (1, None), (3, None), (16, None), (32, None), (129, None),  # one element a thread
    (129, 8), (32, 4), (5, 2), (7, 1),  # chunks of several elements a thread
])
def test_tree_grouped_running_sum_matches_serial_chain_as_points(Gs, threads):
    n_lanes = 3
    pts = fixtures.distinct_points_fast(Gs * n_lanes, seed=Gs)
    lanes = [[oc.IDENTITY] * Gs, pts[Gs : 2 * Gs], pts[2 * Gs :]]
    lanes[1][0] = lanes[1][-1] = oc.IDENTITY  # identity elements inside a lane
    flat = [lanes[w][r] for r in range(Gs) for w in range(n_lanes)]
    s = mont_planes_from_points(flat).reshape(4, 16, Gs, n_lanes).transpose(2, 0, 1, 3).copy()
    if threads is None:
        T, U = pk.grouped_running_sum(planes_from_numpy(s))
    else:  # a split that the default plan takes only at many more lanes
        T, U = (t.to(torch.int32) for t in pk._tree_sums(planes_from_numpy(s), threads))
    assert T.dtype == U.dtype == torch.int32 and T.shape == U.shape == (4, 16, n_lanes)
    got = list(zip(affine_from_planes(planes_to_numpy(T)), affine_from_planes(planes_to_numpy(U))))
    assert got == [serial_sums(lane) for lane in lanes]
    assert got[0] == (oc.to_affine(oc.IDENTITY),) * 2  # the identity lane stays the identity


@pytest.mark.parametrize("Gs,lanes,most,want", [
    (32, 2580, 256, (8, 4)),   # the first pass of a 2^20 MSM: the card is full at 8 threads a lane
    (129, 40, 128, (128, 2)),  # a cap on the threads: chunks of 2
    (129, 40, 256, (256, 1)),
    (1, 6, 256, (1, 1)),
    (3, 6, 256, (4, 1)),
    (40000, 2, 256, (256, 157)),
])
def test_group_plan(Gs, lanes, most, want):
    assert pk._group_plan(Gs, lanes, most) == want


@pytest.mark.parametrize("T_shape,U_shape,n_windows,doublings", [
    ((4, 16, 6), (4, 16, 5), 2, 1),   # T and U of different widths
    ((4, 16, 6), (4, 16, 6), 4, 1),   # 6 lanes, 4 windows
    ((4, 16, 6), (4, 16, 6), 2, -1),  # a negative number of doublings
])
def test_reduce_finish_rejects_bad_arguments(T_shape, U_shape, n_windows, doublings):
    T, U = torch.zeros(T_shape, dtype=torch.int32), torch.zeros(U_shape, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.reduce_finish(T, U, n_windows, doublings)
