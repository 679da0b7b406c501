"""The wire input stage: `to_niels_xy_rows` (wire x||y rows to the scan's
packed Niels rows in one kernel) against the JAX package's `_wire_niels`,
and the host stage around it: one z == 1 check a call, in the API, x||y
and scalars written once into (pinned) host tensors with an identity /
zero tail.

Every comparison is exact, digit for digit. The JAX side runs two eager
calls, of 64 and 32 rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.engines import tpu_engine as te
from webgpu_msm_tpu.oracle import field as F

import webgpu_msm_tpu_torch as tm
from webgpu_msm_tpu_torch import MSMConfig, api
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.ops import pippenger
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle import curve, msm
from webgpu_msm_tpu_torch.oracle.curve import ExtPoint
from webgpu_msm_tpu_torch.utils import convert, fixtures
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy, planes_to_numpy

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

M = 64
STATIC = dict(window_size=8, n_chunks=4, chunk_len=4)  # batches of 16
CFG = MSMConfig(**STATIC)
N = 21  # two batches, the second padded with 11 identity rows


def be_words(v: int) -> np.ndarray:
    return convert.bigints_to_u32_be([v])[0]


@pytest.fixture(scope="module")
def xy_rows():
    """64 wire x||y rows of raw words, seeded: random words (most >= p),
    then rows of zeros, all-ones words, the identity (x = 0, y = 1), x = p
    and y = p + 1, and x = p - 1, y = 2^256 - 1."""
    xy = np.random.default_rng(61).integers(0, 1 << 32, size=(M, 16), dtype=np.uint32)
    xy[0] = 0
    xy[1] = 0xFFFFFFFF
    xy[2] = 0
    xy[2, 15] = 1
    xy[3] = np.concatenate([be_words(F.P), be_words(F.P + 1)])
    xy[4] = np.concatenate([be_words(F.P - 1), be_words((1 << 256) - 1)])
    return xy


def rows_of_planes(niels: np.ndarray) -> np.ndarray:
    """[3, 16, M] digit planes -> [M, 24] LE u32 word rows, in numpy."""
    d = niels.astype(np.uint32)
    return (d[:, 0::2] | (d[:, 1::2] << 16)).reshape(24, -1).T


def test_to_niels_xy_rows_plain_matches_jax(xy_rows):
    got = planes_to_numpy(pk.to_niels_xy_rows_plain(planes_from_numpy(xy_rows)))
    want = rows_of_planes(np.asarray(te._wire_niels(jnp.asarray(xy_rows))))
    np.testing.assert_array_equal(got, want)
    # The identity row gives (R, R, 0): y-x = y+x = R, 2d*t = 0.
    r_words = convert.bigints_to_words_le([F.R % F.P])[:, 0]
    np.testing.assert_array_equal(got[2], np.concatenate([r_words, r_words, np.zeros(8, np.uint32)]))


def test_to_niels_xy_rows_is_the_old_chain(xy_rows):
    """The wrapper on a CPU tensor runs the plain version, which equals the
    chain it replaces: `_wire_niels` (BE unpack and `to_niels_xy`), then
    `pack_rows`; no kernel launch is counted."""
    xy = planes_from_numpy(xy_rows)
    before = dict(pk.launches)
    got = pk.to_niels_xy_rows(xy)
    assert pk.launches == before
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, 24)
    assert torch.equal(got, pippenger.pack_rows(gpu_engine._wire_niels(xy)))
    assert torch.equal(got, pk.to_niels_xy_rows_plain(xy))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_to_niels_xy_rows_checks_its_argument(xy_rows, bad):
    xy = planes_from_numpy(xy_rows)
    if bad == "dtype":
        xy, exc = xy.to(torch.int64), TypeError
    elif bad == "shape":
        xy, exc = xy[:, :15].contiguous(), ValueError
    elif bad == "contiguity":
        xy, exc = xy.t().contiguous().t(), ValueError
    else:  # neither CPU nor CUDA: no plain fallback either
        xy, exc = xy.to("meta"), ValueError
    with pytest.raises(exc):
        pk.to_niels_xy_rows(xy)


# ---- the host stage and the wire path -------------------------------------

@pytest.fixture(scope="module")
def case():
    pts = fixtures.distinct_points_fast(N, seed=62)
    sc = fixtures.random_scalars(N, seed=63)
    sc[:2] = [0, F.P - 1]
    want = curve.to_affine(msm.msm(pts, sc, 8))
    return pts, sc, fixtures.wire_points(pts), convert.bigints_to_u32_be(sc), want


def test_stage_writes_rows_once_with_identity_tail(case):
    _, _, pw, sw, _ = case
    cpu = torch.device("cpu")
    xy = gpu_engine._stage_xy(pw, 32, cpu).rows(0, 32)
    sc = gpu_engine._stage_scalars(sw, 32, cpu).rows(0, 32)
    assert xy.dtype == sc.dtype == torch.int32
    want_xy = np.zeros((32, 16), np.uint32)
    want_xy[:N] = pw[:, :16]
    want_xy[N:, 15] = 1
    want_sc = np.zeros((32, 8), np.uint32)
    want_sc[:N] = sw
    np.testing.assert_array_equal(planes_to_numpy(xy), want_xy)
    np.testing.assert_array_equal(planes_to_numpy(sc), want_sc)


@pytest.mark.parametrize("device_affine", [False, True], ids=["extended", "device-affine"])
def test_wire_compute_msm_with_padded_tail_matches_oracle(case, device_affine, monkeypatch):
    """n = 21 in batches of 16: the second batch is 11 identity rows with
    zero scalars. Each batch converts once, in `to_niels_xy_rows`."""
    _, _, pw, sw, want = case
    calls = []
    monkeypatch.setattr(pk, "to_niels_xy_rows",
                        lambda t, f=pk.to_niels_xy_rows: (calls.append(t.shape[0]), f(t))[1])
    got = tm.compute_msm(pw, sw, config=MSMConfig(device_affine=device_affine, **STATIC),
                         device="cpu")
    assert (got.x, got.y) == want and calls == [16, 16]


@pytest.mark.parametrize("entry", ["compute_msm", "batch-shared", "batch-distinct", "plan"])
def test_api_checks_z_once_per_call(case, entry, monkeypatch):
    """The API's check decides the route and the engine takes its rows
    without a second z pass; a point array that several jobs share is
    checked once."""
    _, _, pw, sw, want = case
    seen = []
    monkeypatch.setattr(gpu_engine, "z_is_one",
                        lambda rows, f=gpu_engine.z_is_one: (seen.append(rows.shape[0]), f(rows))[1])
    if entry == "compute_msm":
        got = [tm.compute_msm(pw, sw, config=CFG, device="cpu")]
    elif entry == "plan":
        got = [tm.MSMPlan(pw, config=CFG, device="cpu").msm(sw)]
    else:
        other = pw if entry == "batch-shared" else pw.copy()
        got = tm.compute_msm_batch([pw, other], [sw, sw], config=CFG, device="cpu")
    assert [(r.x, r.y) for r in got] == [want] * len(got)
    assert seen == [N] * (2 if entry == "batch-distinct" else 1)


def z_not_one(pw: np.ndarray) -> np.ndarray:
    """The same points with z = 7 (x, y, t scaled by 7)."""
    bad = pw.copy()
    for c in range(3):
        vals = [v * 7 % F.P for v in convert.u32_be_to_bigints(pw[:, 8 * c : 8 * c + 8])]
        bad[:, 8 * c : 8 * c + 8] = convert.bigints_to_u32_be(vals)
    bad[:, 24:] = be_words(7)
    return bad


def test_api_check_rejects_z_not_one(case):
    """The API's check is the only one: it rejects rows with z != 1 and
    rows with z's 1 in another word, so they never reach a wire stage
    unmarshalled; the engines take the rows it passes without a z test."""
    _, _, pw, sw, _ = case
    moved = pw.copy()
    moved[0, 31], moved[0, 24] = 0, 1  # z's 1 in another word of the row
    for bad in (z_not_one(pw), moved):
        assert api._wire_point_rows(bad) is None
        assert api._wire_inputs(bad, sw) is None
        assert not api._wire_fast_path_ok(bad, sw)
    assert np.shares_memory(api._wire_inputs(pw, sw)[0], pw)  # taken as it is, no copy


def test_z_not_one_is_marshalled_on_the_host(case, monkeypatch):
    """Rows with z != 1 fail the API's check, are normalized on the host
    and reach the engine's one wire entry as marshalled rows with z == 1."""
    _, _, pw, sw, want = case
    bad = z_not_one(pw)
    seen = []
    monkeypatch.setattr(gpu_engine, "msm_affine_wire",
                        lambda p, *a, _f=gpu_engine.msm_affine_wire: (seen.append(p), _f(p, *a))[1])
    got = tm.compute_msm(bad, sw, config=CFG, device="cpu")
    assert (got.x, got.y) == want and len(seen) == 1
    np.testing.assert_array_equal(seen[0], pw)  # z normalized to 1 on the host
    got = tm.compute_msm(pw, sw, config=CFG, device="cpu")
    assert (got.x, got.y) == want and len(seen) == 2 and np.shares_memory(seen[1], pw)


def test_wide_and_foreign_integer_arrays(case):
    """int64 arrays are range-checked, not cut; in range, and as big-endian
    u32 arrays, they give the u32 result."""
    _, _, pw, sw, want = case
    for p, s in ((pw.astype(np.int64), sw.astype(np.int64)), (pw.astype(">u4"), sw.astype(">u4"))):
        got = tm.compute_msm(p, s, config=CFG, device="cpu")
        assert (got.x, got.y) == want
    for bad_value in (1 << 32, -1):
        p = pw.astype(np.int64)
        p[3, 5] = bad_value
        with pytest.raises(ValueError, match="u32 range"):
            tm.compute_msm(p, sw, config=CFG, device="cpu")
        s = sw.astype(np.int64)
        s[3, 5] = bad_value
        with pytest.raises(ValueError, match="u32 range"):
            tm.compute_msm(pw, s, config=CFG, device="cpu")


def test_z_is_one_reads_the_last_four_u64_words():
    rows = np.zeros((3, 32), np.uint32)
    rows[:, 31] = 1
    assert gpu_engine.z_is_one(rows)
    for word in (24, 27, 30):
        bad = rows.copy()
        bad[1, word] = 1
        assert not gpu_engine.z_is_one(bad)
    bad = rows.copy()
    bad[2, 31] = 0x100  # a 1 in another byte of the low word
    assert not gpu_engine.z_is_one(bad)


def plain_z_is_one(rows: np.ndarray) -> bool:
    """The plain z test: numpy compares the last four u64 words of every
    row with z == 1's."""
    z_one = np.array([0] * 7 + [1], dtype=np.uint32).view(np.uint64)
    return bool((rows.view(np.uint64)[:, 12:] == z_one).all())


ROWS_2P17 = 1 << 17
Z_CASES = (
    [pytest.param(n, (), None, id=f"clean-{n}") for n in (1, 3, (1 << 16) + 1, (1 << 18) + 3)]
    + [pytest.param(ROWS_2P17, (70_000,), (w, 0 if w == 31 else 1), id=f"word-{w}")
       for w in range(24, 32)]
    + [pytest.param(ROWS_2P17, (70_000,), (31, 0x100), id="low-word-other-byte")]
    + [pytest.param(ROWS_2P17, (r,), (31, 7), id=f"row-{r}")
       for r in (0, 32_767, 32_768, 65_535, ROWS_2P17 - 1)]
    + [pytest.param(ROWS_2P17, "all", (31, 7), id="every-row")]
)


@pytest.mark.parametrize("path", ["serial", "parallel"])
@pytest.mark.parametrize("n, bad_rows, bad_word", Z_CASES)
def test_z_is_one_equals_the_plain_test(n, bad_rows, bad_word, path, monkeypatch):
    """Both passes of the z test against the plain one, on one and on four
    threads: the rows on either side of a likely block boundary of the
    threads, the first and last rows, each of z's eight words."""
    monkeypatch.setattr(gpu_engine, "_Z_PARALLEL_ROWS", 1 if path == "parallel" else 1 << 30)
    rows = np.random.default_rng(n).integers(0, 1 << 32, size=(n, 32), dtype=np.uint32)
    rows[:, 24:] = 0
    rows[:, 31] = 1
    if bad_word is not None:
        word, value = bad_word
        rows[slice(None) if bad_rows == "all" else list(bad_rows), word] = value
    want = bad_word is None
    assert plain_z_is_one(rows) == want
    threads = torch.get_num_threads()
    try:
        for t in (1, 4):
            torch.set_num_threads(t)
            assert gpu_engine.z_is_one(rows) == want
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("entry", ["wire", "fortran-order", "int64", "batch-shared"])
def test_z_test_runs_once_a_call_and_copies_only_foreign_arrays(case, entry, monkeypatch):
    """One z test a call, or a point array shared by the jobs of a batch,
    over its n rows; a point array is copied first only when it is not
    contiguous u32 (Fortran order, or a wider integer type)."""
    _, _, pw, sw, want = case
    tests, copies = [], []
    monkeypatch.setattr(gpu_engine, "z_is_one",
                        lambda rows, f=gpu_engine.z_is_one: (tests.append(rows.shape[0]), f(rows))[1])
    contiguous = np.ascontiguousarray

    def counted(a, *args, **kwargs):
        out = contiguous(a, *args, **kwargs)
        if out.shape[-1:] == (32,) and not np.may_share_memory(out, points):
            copies.append(out.shape[0])
        return out

    monkeypatch.setattr(np, "ascontiguousarray", counted)
    if entry == "batch-shared":
        points = pw
        got = tm.compute_msm_batch([pw, pw], [sw, sw], config=CFG, device="cpu")
    else:
        points = {"wire": pw, "fortran-order": np.asfortranarray(pw),
                  "int64": pw.astype(np.int64)}[entry]
        got = [tm.compute_msm(points, sw, config=CFG, device="cpu")]
    assert [(r.x, r.y) for r in got] == [want] * len(got)
    assert tests == [N]
    assert copies == ([N] if entry in ("fortran-order", "int64") else [])


def test_plan_from_jax_niels_planes_runs_the_same_jobs(case):
    """A JAX plan's resident state is Niels planes; `from_state` packs them
    once into the rows a plan built from the wire rows holds, and the jobs
    give the same results."""
    pts, sc, pw, sw, want = case
    built = gpu_engine.WirePlan(pw, CFG, "cpu")
    xy = planes_to_numpy(gpu_engine._stage_xy(pw, built.pad_to, torch.device("cpu")).rows(0, built.pad_to))
    niels = [np.asarray(te._wire_niels(jnp.asarray(xy)))[..., b * 16 : (b + 1) * 16]
             for b in range(2)]
    plan = gpu_engine.WirePlan.from_state(
        [planes_from_numpy(a) for a in niels], n=N, w=built.w, C=built.C, L=built.L,
        pad_to=built.pad_to, config=CFG, device="cpu")
    for a, b in zip(plan._rows, built._rows):
        assert torch.equal(a, b)
    sc2 = fixtures.random_scalars(N, seed=64)
    jobs = [sw, convert.bigints_to_u32_be(sc2)]
    assert plan.msm_affine_batch(jobs) == built.msm_affine_batch(jobs) == [
        want, curve.to_affine(msm.msm(pts, sc2, 8))]
    scaled = [ExtPoint(p.x * 5 % F.P, p.y * 5 % F.P, p.t * 5 % F.P, 5) for p in pts]
    assert (tm.MSMPlan(scaled, config=CFG, device="cpu").msm(sc) == tm.AffinePoint(*want))
