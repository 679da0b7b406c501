"""The port's multi-GPU layer (`webgpu_msm_tpu_torch/parallel/msm_sharded.py`)
against the JAX package's, on virtual meshes on the CPU.

- `tree_add_points` digit for digit against the JAX one;
- the stages and one `msm_window_sums_sharded` call on the conftest's 8
  virtual devices, with the statics of `tests/test_sharded.py`'s
  fixed-base plan test (w 8 signed, C 8 x L 8, so the JAX staged programs
  are the ones that test builds), against the port on
  `default_mesh(8, device="cpu")`: each shard's bucket sums digit for digit
  against the JAX `_stage_accumulate`, the buckets-mode combine digit for
  digit against the JAX tree of those sums (op by op under
  `jax.disable_jit()`), and the local reductions, the combine and the
  call's window sums as points (the reductions add in another order);
- both collective modes and both digit forms, `ShardedFixedBasePlan` and
  the count checks against the oracle, and the launch of a kernel on the
  card of its tensors.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.parallel import msm_sharded as jms

from webgpu_msm_tpu_torch.config import MSMConfig
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.ops import pippenger
from webgpu_msm_tpu_torch.ops.kernels import build
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle import curve
from webgpu_msm_tpu_torch.oracle import msm as omsm
from webgpu_msm_tpu_torch.parallel import (
    ShardedFixedBasePlan, default_mesh, msm_window_sums_sharded, sharded_stages, tree_add_points,
)
from webgpu_msm_tpu_torch.parallel.msm_sharded import window_sums_affine
from webgpu_msm_tpu_torch.utils import fixtures
from webgpu_msm_tpu_torch.utils.interop import (
    affine_from_planes, mont_planes_from_points, planes_from_numpy, planes_to_numpy,
)

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

W_, C_, L_ = 8, 8, 8
STATIC = dict(window_size=W_, n_chunks=C_, chunk_len=L_, signed_digits=True)


def inputs(n: int, seed: int, points=None):
    """n distinct points (or `points`) as [3, 16, n] Montgomery Niels planes
    (numpy u32), [8, n] LE scalar words, and the points and scalars."""
    pts = points if points is not None else fixtures.distinct_points_fast(n, seed=seed)
    sc = fixtures.random_scalars(n, seed=seed + 1)
    niels = planes_to_numpy(pk.to_niels(planes_from_numpy(gpu_engine.marshal_points(pts, n))))
    return niels, gpu_engine.marshal_scalars(sc, n), pts, sc


def oracle(pts, sc, w=W_):
    return curve.to_affine(omsm.msm(pts, sc, window_size=w))


# ---- tree_add_points -------------------------------------------------------


@pytest.mark.parametrize("D,batch", [(5, ()), (8, (3,))], ids=["D5-point", "D8-batch3"])
def test_tree_add_points_matches_jax(D, batch, monkeypatch):
    """[D, 4, 16, *batch] -> [4, 16, *batch], digit for digit, one
    `padd_masked` a level; each lane equals the oracle's sum of its D points."""
    k = int(np.prod(batch, dtype=int))
    pts = fixtures.distinct_points_fast(D * k, seed=90 + D)
    per_dev = mont_planes_from_points(pts).reshape((4, 16) + batch + (D,))
    per_dev = np.ascontiguousarray(np.moveaxis(per_dev, -1, 0))  # [D, 4, 16, *batch]
    with jax.disable_jit():
        ref = np.asarray(jms.tree_add_points(jnp.asarray(per_dev)))
    levels = []
    real = pk.padd_masked
    monkeypatch.setattr(pk, "padd_masked", lambda *a: levels.append(a[0].shape) or real(*a))
    got = tree_add_points(planes_from_numpy(per_dev))
    assert got.shape == (4, 16) + batch and got.dtype == torch.int32
    np.testing.assert_array_equal(planes_to_numpy(got), ref)
    assert len(levels) == (D - 1).bit_length()
    want = [curve.IDENTITY] * k
    for i, p in enumerate(pts):  # lane j of shard d holds point j * D + d
        want[i // D] = curve.add(want[i // D], p)
    got_pts = affine_from_planes(planes_to_numpy(got).reshape(4, 16, k))
    assert got_pts == [curve.to_affine(p) for p in want]


def test_tree_add_points_one_shard_launches_nothing(monkeypatch):
    st = planes_from_numpy(mont_planes_from_points(fixtures.distinct_points_fast(3, seed=97)))[None]
    monkeypatch.setattr(pk, "padd_masked", lambda *a: pytest.fail("padd_masked called at D 1"))
    assert torch.equal(tree_add_points(st), st[0])


# ---- the stages and the call against the JAX package's, D 8 ---------------


@pytest.fixture(scope="module")
def eight_shards():
    return inputs(8 * C_ * L_, seed=83)


@pytest.fixture(scope="module")
def jax_d8(eight_shards):
    """The JAX package's compiled stages on the conftest's 8 virtual CPU
    devices (w 8, C 8 x L 8, signed, window_sums: the statics, and so the
    staged programs, of its own fixed-base plan test), each shard's output
    kept, and one `msm_window_sums_sharded` call: (bucket sums
    [8, 4, 16, K, B], local window sums [8, 4, 16, K], their combine, the
    call's window sums), numpy u32."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert len(jax.devices()) == 8, jax.devices()
    niels, words, _, _ = eight_shards
    mesh = jms.default_mesh(8)
    stages = dict(jms.sharded_stages(mesh=mesh, mode="window_sums", **STATIC))
    on_mesh = lambda a, spec: jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
    acc = stages["accumulate"](on_mesh(niels, P(None, None, jms.AXIS)), on_mesh(words, P(None, jms.AXIS)))
    red = stages["reduce"](acc)
    total = stages["combine"](red)
    call = jms.msm_window_sums_sharded(jnp.asarray(niels), jnp.asarray(words), mesh=mesh, **STATIC)
    return tuple(np.asarray(a) for a in (acc, red, total, call))


@pytest.fixture(scope="module")
def port_d8(eight_shards):
    """The port's stages on 8 virtual CPU shards: (bucket sums, local window
    sums, their combine)."""
    niels, words, _, _ = eight_shards
    stages = dict(sharded_stages(mesh=default_mesh(8, device="cpu"), mode="window_sums", **STATIC))
    acc = stages["accumulate"](planes_from_numpy(niels), planes_from_numpy(words))
    red = stages["reduce"](acc)
    return acc, red, stages["combine"](red)


def test_stage_accumulate_matches_jax(jax_d8, port_d8):
    """Each shard's bucket sums, digit for digit."""
    assert len(port_d8[0]) == 8
    for i, b in enumerate(port_d8[0]):
        np.testing.assert_array_equal(planes_to_numpy(b), jax_d8[0][i], err_msg=f"shard {i}")


def test_stage_reduce_and_combine_match_jax_as_points(jax_d8, port_d8):
    """window_sums mode: each shard's window sums and their combine equal
    the JAX stages' as points."""
    for i, r in enumerate(port_d8[1]):
        assert affine_from_planes(planes_to_numpy(r)) == affine_from_planes(jax_d8[1][i]), f"shard {i}"
    assert affine_from_planes(planes_to_numpy(port_d8[2])) == affine_from_planes(jax_d8[2])


def test_buckets_combine_matches_jax_tree(eight_shards, jax_d8, port_d8):
    """buckets mode on the first two shards: the gathered bucket sums
    tree-added digit for digit as the JAX tree adds the JAX stage's, then
    one reduction, equal as points to the combine of the two shards'
    window sums."""
    niels, words, _, _ = eight_shards
    M = 2 * C_ * L_
    stages = dict(sharded_stages(mesh=default_mesh(2, device="cpu"), mode="buckets", **STATIC))
    combined = stages["combine"](stages["accumulate"](planes_from_numpy(niels[:, :, :M]),
                                                      planes_from_numpy(words[:, :M])))
    with jax.disable_jit():
        want = np.asarray(jms.tree_add_points(jnp.asarray(jax_d8[0][:2])))
    np.testing.assert_array_equal(planes_to_numpy(combined), want)
    got = affine_from_planes(planes_to_numpy(stages["reduce"](combined)))
    pair = stages["combine"]([port_d8[1][0], port_d8[1][1]])
    assert got == affine_from_planes(planes_to_numpy(pair))


def test_matches_jax_sharded_on_8_devices(eight_shards, jax_d8):
    """The JAX `msm_window_sums_sharded` on 8 virtual devices and the port's
    on 8 virtual shards: the same window sums as points, and the oracle's
    result."""
    niels, words, pts, sc = eight_shards
    got = msm_window_sums_sharded(
        planes_from_numpy(niels), planes_from_numpy(words), mesh=default_mesh(8, device="cpu"), **STATIC
    )
    assert got.shape == (4, 16, 32) and got.dtype == torch.int64
    assert affine_from_planes(planes_to_numpy(got)) == affine_from_planes(jax_d8[3])
    assert window_sums_affine(got, W_) == oracle(pts, sc)


# ---- the stage names --------------------------------------------------------


def jax_stage_names(D, mode, monkeypatch):
    """The export names the JAX `_sharded_stage` gives each stage on D
    virtual devices: every exported stage called once with
    `exported_call` recording its name (nothing traced or compiled)."""
    from webgpu_msm_tpu.utils import cache as jcache

    names = []
    monkeypatch.setattr(jms, "_use_stage_exports", lambda: True)
    monkeypatch.setattr(jcache, "exported_call", lambda name, fn, *args: names.append(name))
    for _, fn in jms.sharded_stages(mesh=jms.default_mesh(D), mode=mode, **STATIC):
        if not hasattr(fn, "lower"):  # buckets mode's reduce is a plain jit, no export
            fn(None)
    return names


@pytest.mark.parametrize("mode", ["window_sums", "buckets"])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_stage_names_equal_the_jax_exports(D, mode, monkeypatch):
    """With `cache.stage_call` recording (a stub in place of the card's
    graphs: each call returns zeros of its output's shape), one call a
    shard of accumulate (and of the reduction in window_sums mode), one
    combine at D > 1 and one reduction in buckets mode, under the JAX
    export names: `sharded_acc_D{D}_cuda_{stat}` with the JAX `{stat}`
    string, `sharded_reduce_D{D}`, `sharded_combine_D{D}`, and
    `sharded_reduce_rep_D{D}` for the JAX `reduce_rep`."""
    from webgpu_msm_tpu_torch.utils import cache

    K, B = 32, pippenger.n_buckets(W_, True)
    calls = []

    def stage_call(name, fn, *args, clone=True):
        calls.append((name, [tuple(a.shape) for a in args]))
        shape = {"acc": (4, 16, K, B), "combine": args[0].shape[1:]}.get(name.split("_")[1], (4, 16, K))
        return torch.zeros(shape, dtype=torch.int32)

    monkeypatch.setattr(cache, "stage_call", stage_call)
    M = C_ * L_
    msm_window_sums_sharded(torch.zeros((3, 16, D * M), dtype=torch.int32),
                            torch.zeros((8, D * M), dtype=torch.int32),
                            mesh=default_mesh(D, device="cpu"), mode=mode, **STATIC)
    jax_names = jax_stage_names(D, mode, monkeypatch)
    stat = jax_names[0].split(f"sharded_acc_D{D}_cpu_")[1]
    assert stat == "chunk_len8_n_chunks8_signed_digitsTrue_window_size8"
    acc = [(f"sharded_acc_D{D}_cuda_{stat}", [(M, 24), (8, M)])] * D
    combine = [(f"sharded_combine_D{D}", [(1, 4, 16, K) + ((B,) if mode == "buckets" else ())] * D)]
    combine = combine if D > 1 else []
    if mode == "window_sums":
        want = acc + [(f"sharded_reduce_D{D}", [(4, 16, K, B)])] * D + combine
    else:
        want = acc + combine + [(f"sharded_reduce_rep_D{D}", [(4, 16, K, B)])]
    assert calls == want
    # JAX: sharded_{name}_D{D}_{backend}_{stat}; the port keeps the backend
    # and {stat} where there are statics, and runs no combine at D 1
    from_jax = {j.replace("_cpu_", "_cuda_") if stat in j else j.split("_cpu_")[0]
                for j in jax_names if D > 1 or not j.startswith("sharded_combine")}
    assert from_jax == {name for name, _ in want} - {f"sharded_reduce_rep_D{D}"}


# ---- the modes, the plan and the checks ------------------------------------


@pytest.fixture(scope="module")
def four_shards():
    """64 points for four shards of C 4 x L 4, scalars 0..5 equal (so buckets
    run over several lanes), and the oracle's result."""
    niels, words, pts, sc = inputs(64, seed=85)
    words[:, :6] = words[:, :1]
    sc[:6] = [sc[0]] * 6
    return niels, words, oracle(pts, sc)


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("mode", ["window_sums", "buckets"])
def test_modes_match_oracle(four_shards, mode, signed):
    niels, words, want = four_shards
    wsums = msm_window_sums_sharded(
        planes_from_numpy(niels), planes_from_numpy(words), window_size=W_, n_chunks=4, chunk_len=4,
        mesh=default_mesh(4, device="cpu"), mode=mode, signed_digits=signed,
    )
    assert window_sums_affine(wsums, W_) == want


def test_sharded_fixed_base_plan(monkeypatch):
    """Bases placed once as packed rows; two scalar jobs (the repeated-base
    case: 16 distinct points, repeated) run neither `pack_rows` nor
    `to_niels`; a count mismatch raises."""
    base = fixtures.distinct_points_fast(16, seed=87)
    pts = [base[i % 16] for i in range(64)]
    niels, _, _, _ = inputs(64, seed=87, points=pts)
    plan = ShardedFixedBasePlan(planes_from_numpy(niels), window_size=W_, n_chunks=4, chunk_len=4,
                                mesh=default_mesh(4, device="cpu"), signed_digits=True)
    assert plan.n_global == 64
    for name in ("pack_rows", "to_niels"):
        for mod in (pippenger, pk):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, lambda *a, _n=name: pytest.fail(f"a job ran {_n}"))
    for seed in (18, 19):
        sc = fixtures.random_scalars(64, seed=seed)
        wsums = plan.window_sums(planes_from_numpy(gpu_engine.marshal_scalars(sc, 64)))
        assert window_sums_affine(wsums, W_) == oracle(pts, sc), f"job seed={seed}"
    with pytest.raises(ValueError, match="plan holds 64 bases"):
        plan.window_sums(torch.zeros((8, 32), dtype=torch.int32))


def test_point_count_and_mode_are_checked():
    mesh = default_mesh(2, device="cpu")
    niels, words, _, _ = inputs(2 * 16, seed=89)
    call = lambda pts, sw, **kw: msm_window_sums_sharded(
        planes_from_numpy(pts), planes_from_numpy(sw), window_size=W_, n_chunks=4, chunk_len=4,
        mesh=mesh, **kw)
    with pytest.raises(ValueError, match="local shards"):
        call(niels[:, :, :24], words[:, :24])
    with pytest.raises(ValueError, match="local shards"):
        call(niels, words[:, :16])
    with pytest.raises(ValueError, match="collective mode"):
        call(niels, words, mode="psum")
    with pytest.raises(ValueError, match="local shards"):
        ShardedFixedBasePlan(planes_from_numpy(niels), window_size=W_, n_chunks=4, chunk_len=8,
                             mesh=mesh)


def test_default_mesh(monkeypatch):
    """A virtual mesh on a named device; without one, the cards, or an error."""
    mesh = default_mesh(3, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.size == 3 and mesh.offset == 0
    assert default_mesh(device="cpu").size == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="a mesh of 2 devices"):
        default_mesh(2)
    assert default_mesh().devices == (torch.device("cuda", 0),)


def test_collective_mode_default():
    from webgpu_msm_tpu.config import MSMConfig as JaxConfig

    assert MSMConfig().collective_mode == JaxConfig().collective_mode == "window_sums"


def test_launch_runs_on_the_tensors_device(monkeypatch):
    """A launch makes its tensors' card current, passes that card's index to
    the library and launches on that card's current stream."""
    calls, entered = [], []

    class FakeLib:
        def launch_padd(self, *args):
            calls.append(args)
            return 0

    @contextlib.contextmanager
    def cuda_device(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(build, "load", FakeLib)
    monkeypatch.setattr(torch.cuda, "device", cuda_device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 1000 + torch.device(dev).index}))
    monkeypatch.setitem(pk.launches, "padd", 0)
    pk._launch("padd", "launch_padd", torch.device("cuda", 3), 11, 22, 33, 5)
    assert entered == [torch.device("cuda", 3)]
    assert calls == [(11, 22, 33, 5, 3, 1003)]
    assert pk.launches["padd"] == 1
