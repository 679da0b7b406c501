"""The port on the card: each CUDA kernel against its plain version,
`compute_msm` (wire rows and lists, and the hybrid, naive and baseline
engines) and `MSMPlan` against the port's own oracle, and the stage graphs
(`utils/cache.py`) against the eager stages.

Every test here is marked `gpu` and skips without a CUDA device. The file
imports no JAX, because the GPU machine has none; run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py sets up JAX for the other files.)
"""
import threading

import numpy as np
import pytest
import torch

from webgpu_msm_tpu_torch import MSMConfig, MSMPlan, compute_msm, compute_msm_batch
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.ops import pippenger
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle import curve, field, msm
from webgpu_msm_tpu_torch.utils import cache, convert, fixtures
from webgpu_msm_tpu_torch.utils.interop import (affine_from_planes, mont_planes_from_points, planes_from_numpy,
                                               planes_to_numpy)

from torch_inputs import mont_window_sums

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


def raw_xy_rows(rng, m):
    """[m, 16] wire x||y rows of raw u32 words (most above p), with rows of
    zeros, all-ones words and the identity (x = 0, y = 1) first."""
    xy = rng.integers(0, 1 << 32, size=(m, 16), dtype=np.uint32)
    special = np.zeros((3, 16), dtype=np.uint32)
    special[1] = 0xFFFFFFFF
    special[2, 15] = 1
    xy[: min(m, 3)] = special[: min(m, 3)]
    return xy


def _inputs(name, rng, dev, width=300):
    t = lambda arr: planes_from_numpy(arr, dev)
    if name == "to_niels_xy_rows":
        return (t(raw_xy_rows(rng, width)),)
    if name == "to_niels_xy":
        return (t(rand_planes(rng, (2,), width)),)
    if name == "to_niels":
        return (t(rand_planes(rng, (3,), width)),)
    if name == "finish_affine_divsteps":
        return (t(mont_window_sums(rng, width)),)
    if name in ("accumulate_scan", "accumulate_scan_mma"):
        L = 12
        ids = np.sort(rng.integers(0, 40, size=(width, L)), axis=1).T.astype(np.uint32)
        ids |= rng.integers(0, 2, size=(L, width)).astype(np.uint32) << 31
        niels = rand_planes(rng, (3,), L * width).reshape(3, 16, L, width)
        return (t(niels[:, 0::2] | (niels[:, 1::2] << 16)), t(ids))
    if name in ("accumulate_scan_gather", "accumulate_scan_gather_mma"):
        return _gather_inputs(rng, dev, width, 12)
    if name == "reduce_finish":
        return (t(rand_planes(rng, (4,), width)), t(rand_planes(rng, (4,), width)),
                3 if width % 3 == 0 else 1, 5)
    if name == "padd_masked":
        return (t(rand_planes(rng, (4,), width)), t(rand_planes(rng, (4,), width)),
                t(rng.integers(0, 2, size=width).astype(np.uint32)))
    if name == "padd":
        return (t(rand_planes(rng, (4,), width)), t(rand_planes(rng, (4,), width)))
    if name in ("lane_scan", "assemble_buckets"):
        K = 3 if width % 3 == 0 else 1
        final_id, hist, e_pos = _batch_ids(rng, K, width // K)
        if name == "lane_scan":
            return (t(rand_planes(rng, (4,), width)), t(final_id), K)
        return (t(rand_planes(rng, (4,), K * 40)), t(rand_planes(rng, (4,), width)), t(hist),
                t(e_pos), 4, t(rand_planes(rng, (4,), K * 40)))
    return (t(rand_planes(rng, (5, 4), width)),)


def _gather_inputs(rng, dev, width, L, B=40):
    """The gathering scan's arguments: `width` lanes as K windows of C lanes
    of L steps, each window's ids sorted, with random signs."""
    t = lambda arr: planes_from_numpy(arr, dev)
    K = 3 if width % 3 == 0 else 1
    C = width // K
    M = C * L
    digits = rng.integers(0, B, size=(K, M)).astype(np.uint32)
    perm = np.argsort(digits, axis=1, kind="stable").astype(np.uint32)
    ids = np.take_along_axis(digits, perm.astype(np.int64), axis=1)
    ids |= rng.integers(0, 2, size=(K, M)).astype(np.uint32) << 31
    lanes = lambda a: a.reshape(K, C, L).transpose(2, 0, 1).reshape(L, width).copy()
    niels = rand_planes(rng, (3,), M)
    rows = (niels[:, 0::2] | (niels[:, 1::2] << 16)).reshape(24, M).T.copy()
    return (t(rows), t(lanes(perm)), t(lanes(ids)), K, B)


def _batch_ids(rng, K, C, L=4, B=40):
    """The lane scan's and the bucket assembly's integer inputs as a batch
    stage makes them from K windows of C * L sorted bucket ids: final_id
    [K * C] (the id of each lane's last step, sign bit stripped), hist and
    e_pos [K, B]. In window 0 one bucket spans every lane."""
    digits = np.sort(rng.integers(0, B, size=(K, C * L)), axis=1)
    digits[0] = B // 2
    hist = np.stack([np.bincount(d, minlength=B) for d in digits]).astype(np.uint32)
    return digits[:, L - 1 :: L].reshape(-1).astype(np.uint32), hist, np.cumsum(hist, axis=1).astype(np.uint32)


def _kernel_and_plain(name):
    if name == "accumulate_scan_mma":
        return (lambda p, i: pk.accumulate_scan(p, i, use_mma=True),
                lambda p, i: pk.accumulate_scan_plain(p, i, use_mma=True))
    if name == "accumulate_scan_gather_mma":
        return (lambda *a: pk.accumulate_scan_gather(*a, use_mma=True),
                lambda *a: pk.accumulate_scan_gather_plain(*a, use_mma=True))
    if name == "finish_affine_divsteps":
        return pk.finish_affine_divsteps, pk.finish_affine_plain
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


@pytest.mark.parametrize("width", [31, 300, 2049])
@pytest.mark.parametrize("name", ["accumulate_scan_gather", "grouped_running_sum", "reduce_finish"])
def test_redesigned_kernels_at_ragged_widths(cuda, name, width):
    """Widths that are no multiple of a block's lanes: the gathering scan
    (64 lanes a block, whole warps shadowing the last lane), the tree sum
    and the finish (31 and 683 groups a window: chunks of several elements
    a thread)."""
    args = _inputs(name, np.random.default_rng(width), cuda, width=width)
    kernel, plain = _kernel_and_plain(name)
    for g, w in zip(kernel(*args), plain(*args)):
        assert g.device.type == "cuda" and torch.equal(g, w)


@pytest.mark.parametrize("Gs,width,plan", [
    (37, 50, (64, 1)),     # more threads than elements
    (300, 50, (256, 2)),   # the most threads a lane, chunks of 2
    (37, 2049, (16, 3)),   # many lanes: few threads each, chunks of 3
    (129, 5000, (4, 33)),  # long chunks
    (2, 50, (2, 1)),
])
def test_tree_sum_thread_plans_on_card(cuda, Gs, width, plan):
    """The splits of a lane over threads that `_group_plan` takes as the
    lanes and their lengths vary; the finish over one window of `width`
    groups (128 threads, chunks of up to 40)."""
    assert pk._group_plan(Gs, width, pk.GROUP_THREADS) == plan
    s = planes_from_numpy(rand_planes(np.random.default_rng(Gs), (Gs, 4), width), cuda)
    for g, w in zip(pk.grouped_running_sum(s), pk.grouped_running_sum_plain(s)):
        assert torch.equal(g, w)
    T, U = s[0].contiguous(), s[-1].contiguous()
    for g, w in zip(pk.reduce_finish(T, U, 1, 4), pk.reduce_finish_plain(T, U, 1, 4)):
        assert torch.equal(g, w)


def test_reduce_finish_refuses_a_plan_it_cannot_gather_on_card(cuda, monkeypatch):
    """Block 0 of a cluster of 8 gathers 4 x 8 sums into its lanes' slots,
    so it needs 32 lanes a block: a plan of 8 lanes raises at the launch and
    runs nothing."""
    T = planes_from_numpy(rand_planes(np.random.default_rng(5), (4,), 129), cuda)
    monkeypatch.setattr(pk, "_finish_plan", lambda G: (8, 8))
    with pytest.raises(RuntimeError, match="reduce_finish: kernel launch failed"):
        pk.reduce_finish(T, T, 1, 5)
    torch.cuda.synchronize()


@pytest.mark.parametrize("w", [13, 16])
def test_finish_graph_replays_give_the_same_digits_on_card(cuda, w):
    """The finish stage on random bucket sums at the wire (w 13: K 20 of
    129 groups) and the resident (w 16: K 16 of 1 025 groups) shapes: the
    capturing call and two replays of its graph on the same carry, each
    digit for digit the eager finish, one `reduce_finish` launch a call. A
    replay runs the cluster kernel with nothing reset between launches."""
    shape = gpu_engine._identity_carry(w, True, cuda).shape
    carry = planes_from_numpy(rand_planes(np.random.default_rng(w), (4,), shape[2] * shape[3]), cuda)
    carry = carry.reshape(shape)
    cache.clear()
    with cache.eager():
        want = gpu_engine._call_finish(carry, w, True, False)
    for _ in range(3):
        pk.reset_launch_counts()
        assert torch.equal(gpu_engine._call_finish(carry, w, True, False), want)
        assert pk.launches["reduce_finish"] == 1
    assert (cache.stats()["captures"], cache.stats()["replays"]) == (1, 2)


@pytest.mark.parametrize("C", [1, 3, 300, 2048, 4096])
def test_lane_scan_and_assemble_buckets_on_card(cuda, C):
    """The two kernels after the scan, chained as the batch stage chains
    them, against their plain versions: C lanes a window (one partial block,
    a partial cluster of two, a full cluster of 8 x 256, two lanes a
    thread), window 0 one bucket over all its lanes; the bucket assembly
    with and without a carry, which it reads and leaves as it was."""
    rng = np.random.default_rng(C)
    t = lambda arr: planes_from_numpy(arr, cuda)
    K, L, B = 3, 4, 40
    final_id, hist, e_pos = (t(a) for a in _batch_ids(rng, K, C, L, B))
    final_acc = t(rand_planes(rng, (4,), K * C))
    carries = pk.lane_scan(final_acc, final_id, K)
    assert torch.equal(carries, pk.lane_scan_plain(final_acc, final_id, K))
    partial, carry = t(rand_planes(rng, (4,), K * B)), t(rand_planes(rng, (4,), K * B))
    before = carry.clone()
    for c in (None, carry):
        got = pk.assemble_buckets(partial, carries, hist, e_pos, L, c)
        assert torch.equal(got, pk.assemble_buckets_plain(partial, carries, hist, e_pos, L, c))
    assert torch.equal(carry, before)


@pytest.mark.parametrize("m", [1, 3, 129, 1 << 18])
def test_to_niels_xy_rows_on_card(cuda, m):
    """The wire input stage at 1, 3 and 129 rows (a partial block) and at a
    2^20 call's batch, raw words above p included."""
    xy = planes_from_numpy(raw_xy_rows(np.random.default_rng(m), m), cuda)
    got = pk.to_niels_xy_rows(xy)
    assert got.device.type == "cuda" and tuple(got.shape) == (m, 24)
    assert torch.equal(got, pk.to_niels_xy_rows_plain(xy))


def test_equal_scalars_on_card_match_oracle(cuda):
    """2^16 points, every scalar s: every window has one bucket over all its
    lanes, so every level of the lane scan adds, in every lane it can."""
    n = 1 << 16
    pts = fixtures.distinct_points_fast(n, seed=61)
    s = fixtures.random_scalars(1, seed=62)[0]
    total = curve.IDENTITY
    for p in pts:
        total = curve.add(total, p)
    pk.reset_launch_counts()
    got = compute_msm(fixtures.wire_points(pts), convert.bigints_to_u32_be([s] * n), device=cuda)
    assert (got.x, got.y) == curve.to_affine(curve.scalar_mul(total, s))
    assert pk.launches["lane_scan"] == pk.launches["assemble_buckets"] == 1


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
    used = ("to_niels_xy_rows", "accumulate_scan_gather", "lane_scan", "assemble_buckets",
            "grouped_running_sum", "reduce_finish")
    assert all(pk.launches[name] > 0 for name in used), pk.launches
    assert all(pk.launches[name] == 0 for name in pk.KERNELS if name not in used), pk.launches


def test_tensor_core_scan_equals_cios_scan_on_card(cuda):
    args = _inputs("accumulate_scan", np.random.default_rng(11), cuda, width=2049)
    for a, b in zip(pk.accumulate_scan(*args), pk.accumulate_scan(*args, use_mma=True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("width,L", [(31, 12), (301, 12), (300, 1), (33, 1)])
def test_tensor_core_gathering_scan_matches_plain_on_card(cuda, width, L):
    """Ragged widths (the last warp partly beyond W, its lanes shadowing
    lane W - 1) and a single step (L 1: no row read ahead)."""
    args = _gather_inputs(np.random.default_rng(width + L), cuda, width, L)
    before = dict(pk.launches)
    got = pk.accumulate_scan_gather(*args, use_mma=True)
    torch.cuda.synchronize()
    assert pk.launches == {**before, "accumulate_scan_gather_mma": before["accumulate_scan_gather_mma"] + 1}
    for g, w in zip(got, pk.accumulate_scan_gather_plain(*args, use_mma=True)):
        assert torch.equal(g, w)


def test_tensor_core_gathering_scan_equals_cios_gathering_scan_on_card(cuda):
    """A middling shape, 3 windows of 1 000 lanes of 64 steps, over 700
    buckets: kernel against kernel, every output digit."""
    args = _gather_inputs(np.random.default_rng(12), cuda, 3000, 64, B=700)
    for a, b in zip(pk.accumulate_scan_gather(*args), pk.accumulate_scan_gather(*args, use_mma=True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [16, 20])
def test_finish_affine_on_card_matches_plain(cuda, K):
    """The affine finish kernel at the resident (K 16) and wire (K 20)
    windows: every digit of the plain version's, z = 0 mapped to (0, 0)."""
    mont = planes_from_numpy(mont_window_sums(np.random.default_rng(K), K), cuda)
    got = pk.finish_affine_divsteps(mont)
    assert torch.equal(got, pk.finish_affine_plain(mont))
    assert not got[:, :, 1].any() and got[:, :, 0].any()


def test_divstep_finish_over_a_wide_input_with_edge_values_on_card(cuda):
    """The divstep kernel over 4 096 random windows after the edge values
    of z (0, 1, 2, p - 1, p - 2, R mod p, R^2 mod p): digit for digit the
    plain version's on the edge values and the first 505 random windows,
    and the same digits for those windows when they are launched alone."""
    mont = mont_window_sums(np.random.default_rng(30), 4096 + 7)
    for lane, z in enumerate((0, 1, 2, field.P - 1, field.P - 2, field.R % field.P, field.R ** 2 % field.P)):
        mont[3, :, lane] = [(z >> (16 * i)) & 0xFFFF for i in range(16)]
    mont = planes_from_numpy(mont, cuda)
    got = pk.finish_affine_divsteps(mont)
    head = mont[..., :512].contiguous()
    assert torch.equal(got[..., :512], pk.finish_affine_plain(head))
    assert torch.equal(pk.finish_affine_divsteps(head), got[..., :512])
    assert not got[:, :, 0].any()


def test_device_affine_through_the_stage_graphs_on_card(cuda):
    """A `device_affine` wire call: its finish is one graph,
    `finish_affine_w8_s1`, launching `finish_affine_divsteps` once a call;
    the graph calls equal the eager call and the oracle."""
    pts = fixtures.distinct_points_fast(48, seed=57)
    scalars = fixtures.random_scalars(48, seed=58)
    pw, sw = fixtures.wire_points(pts), convert.bigints_to_u32_be(scalars)
    cfg = MSMConfig(window_size=8, n_chunks=4, chunk_len=4, device_affine=True)
    with cache.eager():
        want = compute_msm(pw, sw, config=cfg, device=cuda)
    assert (want.x, want.y) == curve.to_affine(msm.msm(pts, scalars, 8))
    cache.clear()
    for _ in range(2):
        pk.reset_launch_counts()
        assert compute_msm(pw, sw, config=cfg, device=cuda) == want
        assert pk.launches["finish_affine_divsteps"] == 1 and pk.launches["reduce_finish"] == 1
    assert [k[0] for k in cache.CACHE._graphs] == ["wire_batch_w8_c4x4_s1", "finish_affine_w8_s1"]
    assert cache.stats()["captures"] == 2


@pytest.mark.parametrize("device_affine", [False, True])
def test_list_input_on_card_matches_oracle(cuda, device_affine):
    """Lists are marshalled to wire rows by the API and take the wire road:
    one `to_niels_xy_rows` a batch, never `to_niels` or `to_niels_xy`."""
    pts = fixtures.distinct_points_fast(48, seed=53)
    scalars = fixtures.random_scalars(48, seed=54)
    pk.reset_launch_counts()
    got = compute_msm(pts, scalars, device=cuda, config=MSMConfig(
        window_size=8, n_chunks=4, chunk_len=4, device_affine=device_affine))
    assert (got.x, got.y) == curve.to_affine(msm.msm(pts, scalars, 8))
    assert pk.launches["to_niels_xy_rows"] == 3
    assert pk.launches["to_niels"] == pk.launches["to_niels_xy"] == 0


def test_msm_plan_on_card_matches_oracle(cuda):
    pts = fixtures.distinct_points_fast(48, seed=55)
    jobs = [fixtures.random_scalars(48, seed=56 + j) for j in range(2)]
    pk.reset_launch_counts()
    plan = MSMPlan(fixtures.wire_points(pts), device=cuda,
                   config=MSMConfig(window_size=8, n_chunks=4, chunk_len=4))
    assert pk.launches["to_niels_xy_rows"] == 3 and pk.launches["to_niels_xy"] == 0
    got = plan.msm_batch([convert.bigints_to_u32_be(jobs[0]), jobs[1]])
    assert [(r.x, r.y) for r in got] == [curve.to_affine(msm.msm(pts, sc, 8)) for sc in jobs]
    assert pk.launches["to_niels_xy_rows"] == 3 and pk.launches["accumulate_scan_gather"] == 6
    assert pk.launches["to_niels_xy"] == 0


def test_queued_wire_jobs_do_not_share_staging_buffers(cuda):
    """Three wire jobs with distinct point arrays, all queued before any is
    fetched: each writes its rows into its own pinned host buffer, which the
    caching host allocator hands out again only after its copies have run.
    Each result equals the job's single call."""
    n, cfg = 1 << 12, MSMConfig(window_size=10, n_chunks=64, chunk_len=16)
    jobs = [(fixtures.wire_points(fixtures.distinct_points_fast(n, seed=70 + j)),
             convert.bigints_to_u32_be(fixtures.random_scalars(n, seed=80 + j))) for j in range(3)]
    singles = [compute_msm(p, s, config=cfg, device=cuda) for p, s in jobs]
    pk.reset_launch_counts()
    got = compute_msm_batch([p for p, _ in jobs], [s for _, s in jobs], config=cfg, device=cuda)
    assert got == singles
    assert pk.launches["to_niels_xy_rows"] == 3 * 4 and pk.launches["to_niels_xy"] == 0


def test_hybrid_wire_split_on_card_matches_oracle(cuda):
    """2^12 points at cpu_work_ratio 0.2: 819 in the native engine beside
    3 277 on the card's wire path (one batch of 2^12: w 12, C 256, L 16),
    joined by one affine add."""
    n = 1 << 12
    pts = fixtures.distinct_points_fast(n, seed=63)
    scalars = fixtures.random_scalars(n, seed=64)
    pk.reset_launch_counts()
    got = compute_msm(fixtures.wire_points(pts), convert.bigints_to_u32_be(scalars),
                      config=MSMConfig(cpu_work_ratio=0.2), device=cuda)
    assert (got.x, got.y) == curve.to_affine(msm.msm(pts, scalars, 12))
    used = ("to_niels_xy_rows", "accumulate_scan_gather", "lane_scan", "assemble_buckets",
            "grouped_running_sum", "reduce_finish")
    assert pk.launches == {name: int(name in used) for name in pk.KERNELS}


def test_naive_and_baseline_on_card_match_oracle(cuda):
    """The naive engine at n = 1024: its ladder is plain PyTorch on the
    card, its tree sum (1024 - 1).bit_length() = 10 `padd_masked` launches,
    and no other kernel. The baseline launches no kernel."""
    n = 1024
    pts = fixtures.distinct_points_fast(n, seed=65)
    scalars = fixtures.random_scalars(n, seed=66)
    want = curve.to_affine(msm.msm(pts, scalars, 8))
    pk.reset_launch_counts()
    got = compute_msm(pts, scalars, device=cuda, engine="naive")
    assert (got.x, got.y) == want
    assert pk.launches == {name: 10 if name == "padd_masked" else 0 for name in pk.KERNELS}
    pk.reset_launch_counts()
    got = compute_msm(pts[:64], scalars[:64], device=cuda, engine="baseline")
    assert (got.x, got.y) == curve.to_affine(msm.msm(pts[:64], scalars[:64], 8))
    assert not any(pk.launches.values())


@pytest.mark.parametrize("G", [5, 1024, 1 << 16])
def test_padd_masked_at_tree_sum_widths_on_card(cuda, G):
    """`padd_masked` at the naive tree sum's shapes, level by level: W = G
    lanes, b = a rolled by -d, mask lane + d < G."""
    a = planes_from_numpy(rand_planes(np.random.default_rng(G), (4,), G), cuda)
    lane = torch.arange(G, device=cuda)
    for i in range((G - 1).bit_length()):
        d = 1 << i
        b = torch.roll(a, -d, dims=-1)
        mask = (lane + d < G).to(torch.int32)
        got = pk.padd_masked(a, b, mask)
        assert torch.equal(got, pk.padd_masked_plain(a, b, mask))
        a = got


def test_msm_window_sums_at_the_resident_window_on_card(cuda):
    """`msm_window_sums` at the device-resident window w 16 (B 32 800, K 16)
    in one batch of C 64 x L 64, on points already on the card."""
    n, w = 1 << 12, 16
    pts = fixtures.distinct_points_fast(n, seed=47)
    sc = fixtures.random_scalars(n, seed=48)
    pk.reset_launch_counts()
    niels = pk.to_niels(planes_from_numpy(gpu_engine.marshal_points(pts, n), cuda))
    got = pippenger.msm_window_sums(niels, planes_from_numpy(gpu_engine.marshal_scalars(sc, n), cuda),
                                    window_size=w, n_chunks=64, chunk_len=64, signed_digits=True)
    wsums = [curve.from_affine(*xy) for xy in affine_from_planes(planes_to_numpy(got))]
    assert curve.to_affine(msm.combine_windows(wsums, w)) == curve.to_affine(msm.msm(pts, sc, 8))
    for name in ("to_niels", "accumulate_scan_gather", "lane_scan", "assemble_buckets",
                 "grouped_running_sum", "reduce_finish"):
        assert pk.launches[name] == 1, name


@pytest.mark.parametrize("mode", ["window_sums", "buckets"])
def test_virtual_mesh_of_2_on_card_matches_oracle(cuda, mode):
    """The sharded MSM on two shards of cuda:0 (w 8 signed, C 8 x L 8): the
    oracle's result; each shard launches the batch kernels once, the
    reduction runs once a shard (window_sums) or once (buckets), and the
    tree combine launches `padd_masked` once."""
    from webgpu_msm_tpu_torch.parallel import default_mesh, msm_window_sums_sharded
    from webgpu_msm_tpu_torch.parallel.msm_sharded import window_sums_affine

    n, w = 128, 8
    pts = fixtures.distinct_points_fast(n, seed=51)
    sc = fixtures.random_scalars(n, seed=52)
    niels = pk.to_niels(planes_from_numpy(gpu_engine.marshal_points(pts, n), cuda))
    words = planes_from_numpy(gpu_engine.marshal_scalars(sc, n), cuda)
    pk.reset_launch_counts()
    got = msm_window_sums_sharded(niels, words, window_size=w, n_chunks=8, chunk_len=8,
                                  mesh=default_mesh(2, device=cuda), mode=mode, signed_digits=True)
    reductions = 2 if mode == "window_sums" else 1
    assert pk.launches == {
        "accumulate_scan_gather": 2, "lane_scan": 2, "assemble_buckets": 2, "padd_masked": 1,
        "grouped_running_sum": reductions, "reduce_finish": reductions,
        **{k: 0 for k in ("to_niels_xy", "accumulate_scan", "padd", "to_niels", "accumulate_scan_mma",
                          "to_niels_xy_rows", "accumulate_scan_gather_mma", "finish_affine_divsteps")},
    }
    assert window_sums_affine(got, w) == curve.to_affine(msm.msm(pts, sc, w))


@pytest.mark.parametrize("mode", ["window_sums", "buckets"])
def test_virtual_mesh_of_2_through_the_stage_graphs_on_card(cuda, mode):
    """The sharded stages on two shards of cuda:0 through the stage graphs:
    one graph a stage (both shards replay the one of their shared key,
    each output a clone), digit for digit the eager call's, twice."""
    from webgpu_msm_tpu_torch.parallel import default_mesh, msm_window_sums_sharded

    n = 128
    pts = fixtures.distinct_points_fast(n, seed=59)
    sc = fixtures.random_scalars(n, seed=60)
    niels = pk.to_niels(planes_from_numpy(gpu_engine.marshal_points(pts, n), cuda))
    words = planes_from_numpy(gpu_engine.marshal_scalars(sc, n), cuda)
    call = lambda: msm_window_sums_sharded(niels, words, window_size=8, n_chunks=8, chunk_len=8,
                                           mesh=default_mesh(2, device=cuda), mode=mode, signed_digits=True)
    with cache.eager():
        want = call()
    cache.clear()
    for _ in range(2):
        assert torch.equal(call(), want)
    names = sorted(k[0] for k in cache.CACHE._graphs)
    stat = "chunk_len8_n_chunks8_signed_digitsTrue_window_size8"
    reduce = "sharded_reduce_D2" if mode == "window_sums" else "sharded_reduce_rep_D2"
    assert names == sorted([f"sharded_acc_D2_cuda_{stat}", reduce, "sharded_combine_D2"])
    assert cache.stats()["captures"] == 3


@pytest.mark.parametrize("D", [2, 4, 5])
def test_padd_masked_at_the_tree_combine_shape_on_card(cuda, D):
    """`padd_masked` at the buckets-mode tree's shape ([4, 16, K * B * D],
    w 8 signed: K 32, B 160), level by level as `tree_add_points` runs it."""
    from webgpu_msm_tpu_torch.parallel import tree_add_points

    st = planes_from_numpy(rand_planes(np.random.default_rng(D), (D, 4), 32 * 160), cuda)
    st = st.reshape(D, 4, 16, 32, 160)
    a = st.movedim(0, -1).reshape(4, 16, -1).contiguous()
    lane = torch.arange(D, device=cuda).expand(32, 160, D).reshape(-1)
    for i in range((D - 1).bit_length()):
        d = 1 << i
        b = torch.roll(a.reshape(4, 16, 32, 160, D), -d, dims=-1).reshape(a.shape)
        mask = (lane + d < D).to(torch.int32)
        got = pk.padd_masked(a, b, mask)
        assert torch.equal(got, pk.padd_masked_plain(a, b, mask))
        a = got
    assert torch.equal(tree_add_points(st), a.reshape(4, 16, 32, 160, D)[..., 0])


@pytest.mark.parametrize("B", [40, 4128])
def test_suffix_weighted_matches_plain_on_card(cuda, B):
    """The suffix scan of `reduce_buckets(group_size=1)` on the card, one
    `padd_masked` launch a level (2 * ceil(log2 B)), against the same
    function on the CPU (the plain versions), digit for digit."""
    K = 3
    bs = planes_from_numpy(rand_planes(np.random.default_rng(B), (4,), K * B)).reshape(4, 16, K, B)
    pk.reset_launch_counts()
    got = pippenger._suffix_weighted(bs.to(cuda))
    assert pk.launches == {k: 2 * (B - 1).bit_length() if k == "padd_masked" else 0 for k in pk.KERNELS}
    assert torch.equal(got.cpu(), pippenger._suffix_weighted(bs))


@pytest.mark.parametrize("Gs", [1, 4])
def test_reduce_and_finish_group_sizes_on_card(cuda, Gs):
    """`reduce_and_finish(group_size=Gs)` on real bucket sums (K 4, B 2048)
    gives the Gs 32 window sums as points, in both outputs, with the
    launches of its form, and the oracle's running sums."""
    K, B = 4, 2048
    pts = fixtures.distinct_points_fast(K * B, seed=61)
    bs = planes_from_numpy(mont_planes_from_points(pts), cuda).reshape(4, 16, K, B)
    want = affine_from_planes(planes_to_numpy(pippenger.reduce_and_finish(bs, group_size=32)[1]))
    pk.reset_launch_counts()
    plain, mont = pippenger.reduce_and_finish(bs, group_size=Gs)
    counts = ({"padd_masked": 2 * (B - 1).bit_length()} if Gs == 1
              else {"grouped_running_sum": 1, "reduce_finish": 1})
    assert pk.launches == {k: counts.get(k, 0) for k in pk.KERNELS}
    assert affine_from_planes(planes_to_numpy(mont)) == want
    assert affine_from_planes(planes_to_numpy(plain), mont=False) == want
    sums = [msm.bucket_reduce(pts[k * B : (k + 1) * B]) for k in range(K)]
    assert want == [curve.to_affine(s) for s in sums]


# ---------------------------------------------------------------------------
# The stage graphs (utils/cache.py): each stage captured at its first call
# and replayed after, against the eager stages (`cache.eager()`).
# ---------------------------------------------------------------------------


def _pinned(arr):
    return planes_from_numpy(arr).pin_memory()


def _signed_scalars_be(rng, m):
    """[m, 8] BE scalar rows below 2^253 (signed digits apply)."""
    sc = rng.integers(0, 1 << 32, size=(m, 8), dtype=np.uint32)
    sc[:, 0] &= (1 << 29) - 1
    return sc


def _stage_cases(shape, rng, dev):
    """Each stage at the 2^20 wire plan (w 13 signed, C 2048 x L 128) or at
    the device-resident plan (w 16 signed, C 2048 x L 512): (name, fn,
    statics, two argument tuples), the second carrying the first's output
    where the stage takes a carry."""
    w, C, L = (13, 2048, 128) if shape == "wire" else (16, 2048, 512)
    M = C * L
    static = dict(window_size=w, n_chunks=C, chunk_len=L, signed_digits=True)
    carry = gpu_engine._identity_carry(w, True, dev)
    suffix = f"_w{w}_c{C}x{L}_s1"
    with cache.eager():
        if shape == "wire":
            xy = [_pinned(raw_xy_rows(rng, M)) for _ in range(2)]
            sc = [_pinned(_signed_scalars_be(rng, M)) for _ in range(2)]
            rows = [pk.to_niels_xy_rows(x.to(dev)) for x in xy]
            c1 = gpu_engine._call_stage("wire_batch" + suffix, gpu_engine._wire_batch_impl, static,
                                        xy[0], sc[0], carry)
            cases = [
                ("wire_batch" + suffix, gpu_engine._wire_batch_impl, static,
                 [(xy[0], sc[0], carry), (xy[1], sc[1], c1)]),
                (f"plan_niels_m{M}", pk.to_niels_xy_rows, {}, [(x.to(dev),) for x in xy]),
                ("fixed_batch" + suffix, gpu_engine._fixed_batch_impl, static,
                 [(rows[0], sc[0], carry), (rows[1], sc[1], c1)]),
            ]
        else:
            planes = [planes_from_numpy(rand_planes(rng, (3,), M), dev) for _ in range(2)]
            words = [planes_from_numpy(_signed_scalars_be(rng, M)[:, ::-1].T, dev) for _ in range(2)]
            c1 = gpu_engine._batch_planes_impl(planes[0], words[0], carry, **static)
            cases = [("batch_planes" + suffix, gpu_engine._batch_planes_impl, static,
                      [(planes[0], words[0], carry), (planes[1], words[1], c1)])]
        cases.append((f"finish_w{w}_s1", gpu_engine._finish_impl, {}, [(c1,), (carry,)]))
    return cases


@pytest.mark.parametrize("shape", ["wire", "resident"])
def test_stage_replays_equal_eager_runs_on_card(cuda, shape):
    """Every stage at a main path's shapes: the capturing call, a replay on
    the same arguments and a replay on others, each digit for digit equal
    to the eager stage on the same arguments."""
    cache.clear()
    cases = _stage_cases(shape, np.random.default_rng(17), cuda)
    for name, fn, static, arg_sets in cases:
        with cache.eager():
            want = [gpu_engine._call_stage(name, fn, static, *args) for args in arg_sets]
        got = [gpu_engine._call_stage(name, fn, static, *args)
               for args in (arg_sets[0], arg_sets[0], arg_sets[1])]
        for g, w in zip(got, [want[0], want[0], want[1]]):
            assert torch.equal(g, w), name
        assert not torch.equal(want[0], want[1]), name
    s = cache.stats()
    assert (s["captures"], s["replays"]) == (len(cases), 2 * len(cases))


def test_queued_jobs_each_return_their_own_result_on_card(cuda):
    """Three jobs with distinct scalars queued before any is fetched, on the
    wire path, the plan and lists marshalled to wire rows: a replay writes into its
    graph's own outputs, so each job's window sums are cloned right after
    its finish. Each result equals the job's eager call."""
    n, cfg = 1 << 12, MSMConfig(window_size=10, n_chunks=64, chunk_len=16)  # four batches
    pts = fixtures.distinct_points_fast(n, seed=71)
    pw = fixtures.wire_points(pts)
    jobs = [fixtures.random_scalars(n, seed=81 + j) for j in range(3)]
    jobs_be = [convert.bigints_to_u32_be(s) for s in jobs]
    with cache.eager():
        want = [gpu_engine.msm_affine_wire(pw, s, cfg, cuda) for s in jobs_be]
    assert len(set(want)) == 3
    cache.clear()
    for _ in range(2):  # the first round captures, the second only replays
        assert gpu_engine.msm_affine_batch_wire([(pw, s) for s in jobs_be], cfg, cuda) == want
        assert gpu_engine.WirePlan(pw, cfg, cuda).msm_affine_batch(jobs_be) == want
        got = compute_msm_batch([pts, list(pts), list(pts)], jobs, config=cfg, device=cuda)
        assert [(r.x, r.y) for r in got] == want
    assert cache.stats()["replays"] > 0


def test_warm_calls_replay_and_capture_nothing_on_card(cuda):
    """The first call captures the wire batch (then replays it for the
    other three batches) and the finish; a later call captures nothing,
    replays once a stage, and counts the launches of the eager call."""
    n, cfg = 1 << 12, MSMConfig(window_size=10, n_chunks=64, chunk_len=16)
    pts = fixtures.distinct_points_fast(n, seed=72)
    pw, sw = fixtures.wire_points(pts), convert.bigints_to_u32_be(fixtures.random_scalars(n, seed=82))
    pk.reset_launch_counts()
    with cache.eager():
        want = compute_msm(pw, sw, config=cfg, device=cuda)
    eager_counts = dict(pk.launches)
    cache.clear()
    for call in range(3):
        pk.reset_launch_counts()
        assert compute_msm(pw, sw, config=cfg, device=cuda) == want
        assert pk.launches == eager_counts
        s = cache.stats()
        assert (s["graphs"], s["captures"]) == (2, 2)
        assert s["replays"] == 3 + 5 * call
    assert s["bytes"] > 0


def test_warm_calls_do_not_synchronize_on_card(cuda):
    """A warm wire dispatch, plan job dispatch and device-resident call queue
    their copies and replays without waiting for the device (PyTorch's sync
    check raises on a synchronizing call)."""
    n, cfg = 1 << 12, MSMConfig(window_size=10, n_chunks=64, chunk_len=16)
    pts = fixtures.distinct_points_fast(n, seed=73)
    scalars = fixtures.random_scalars(n, seed=83)
    pw, sw = fixtures.wire_points(pts), convert.bigints_to_u32_be(scalars)
    plan = gpu_engine.WirePlan(pw, cfg, cuda)
    planes = planes_from_numpy(gpu_engine.marshal_points(pts, n), cuda)
    words = planes_from_numpy(gpu_engine.marshal_scalars(scalars, n), cuda)
    w, (C, L) = cfg.resolved_window_size(n), cfg.resolved_chunking(n)
    calls = {
        "wire": lambda: gpu_engine._dispatch_wire(pw, sw, cfg, cuda)[0],
        "plan job": lambda: plan.dispatch(sw)[0],
        "resident": lambda: gpu_engine._device_msm(planes, words, window_size=w, n_chunks=C, chunk_len=L,
                                                   signed_digits=True),
    }
    want = {k: fn() for k, fn in calls.items()}  # the captures
    torch.cuda.synchronize()
    for label, fn in calls.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(out, want[label]), label


def _wire_case(n, seed, **config):
    cfg = MSMConfig(**config)
    pts = fixtures.distinct_points_fast(n, seed=seed)
    pw, sw = fixtures.wire_points(pts), convert.bigints_to_u32_be(fixtures.random_scalars(n, seed=seed + 10))
    with cache.eager():
        want = compute_msm(pw, sw, config=cfg, device="cuda")
    return lambda: compute_msm(pw, sw, config=cfg, device="cuda"), want


def test_replayed_launch_counts_equal_the_profiled_kernels_on_card(cuda):
    """A replay runs its kernels without calling their wrappers: the counts
    the cache adds for it equal the kernels the profiler records, by symbol,
    on the capturing call and on a call that only replays."""
    from torch.profiler import ProfilerActivity, profile

    call, want = _wire_case(1 << 12, 74, window_size=10, n_chunks=64, chunk_len=16)  # four batches
    cache.clear()
    for replays in (3, 5):  # the first call replays the batch graph thrice, a warm one every stage
        before = cache.stats()["replays"]
        pk.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            assert call() == want
            torch.cuda.synchronize()
        assert pk.profiled_launches(prof.events()) == pk.launches
        assert pk.launches["accumulate_scan_gather"] == 4 and pk.launches["reduce_finish"] == 1
        assert cache.stats()["replays"] - before == replays


def test_capture_beside_a_thread_pinning_host_memory_on_card(cuda):
    """A capture bars only its own thread from the calls that are illegal
    while capturing: another thread allocating and freeing pinned host
    memory all the while (as a data loader does) goes on, and so do the
    captures."""
    call, want = _wire_case(1 << 12, 75, window_size=10, n_chunks=64, chunk_len=16)
    stop, errors, pinned = threading.Event(), [], [0]

    def pin():
        held = []
        try:
            while not stop.is_set():
                held.append(torch.empty(1 << 16, dtype=torch.uint8, pin_memory=True))
                pinned[0] += 1
                if len(held) == 256:  # free them, so that the next ones are new allocations
                    held.clear()
                    torch._C._host_emptyCache()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    thread = threading.Thread(target=pin)
    thread.start()
    try:
        for _ in range(3):
            cache.clear()
            before = pinned[0]
            assert call() == want
            assert cache.stats()["captures"] == 2 and pinned[0] > before
    finally:
        stop.set()
        thread.join()
    assert not errors


def test_stage_graphs_hold_at_most_their_limit_after_a_w20_call_on_card(cuda, monkeypatch):
    """At w 20 (K 13 windows of 2^19 + 1 buckets) the graphs stay within the
    limit after every call; with a limit under twice the batch graph, that
    stage is not kept and runs eagerly, and every result stays the eager
    one."""
    call, want = _wire_case(1 << 12, 76, window_size=20, n_chunks=64, chunk_len=16)
    cache.clear()
    for _ in range(2):
        assert call() == want
        assert 0 < cache.stats()["bytes"] <= cache.limit(cuda)
    sizes = {k[0]: g.nbytes for k, g in cache.CACHE._graphs.items()}
    sizes.update((k[0], nbytes) for k, nbytes in cache.CACHE.too_large.items())
    assert sorted(sizes) == ["finish_w20_s1", "wire_batch_w20_c64x16_s1"] and cache.stats()["captures"] == 2
    total = torch.cuda.get_device_properties(cuda).total_memory
    monkeypatch.setattr(cache, "MEMORY_SHARE", 1.5 * sizes["wire_batch_w20_c64x16_s1"] / total)
    cache.clear()
    for _ in range(2):
        assert call() == want
        assert cache.stats()["bytes"] <= cache.limit(cuda)
    assert "wire_batch_w20_c64x16_s1" in cache.stats()["too_large"]


def test_a_batch_job_is_fetched_behind_its_own_finish(cuda):
    """A job of a batch has its window sums copied into pinned host memory
    right behind its finish stage (`gpu_engine._HostCopy`), with work
    queued after the copy; its fetch gives the sums. On the CPU the sums
    are passed on as they are."""
    out = torch.arange(4 * 16 * 20, dtype=torch.int64, device=cuda).reshape(4, 16, 20)
    queued, w = gpu_engine._queue_fetch(out, 13)
    assert w == 13 and isinstance(queued, gpu_engine._HostCopy) and queued.host.is_pinned()
    later = torch.ones(1 << 24, device=cuda)
    for _ in range(100):  # device work queued after the copy
        later.mul_(1.0001)
    assert torch.equal(queued.cpu(), torch.arange(4 * 16 * 20, dtype=torch.int64).reshape(4, 16, 20))
    on_cpu = out.cpu()
    assert gpu_engine._queue_fetch(on_cpu, 13)[0] is on_cpu
