"""The port's engine layer against the JAX package's, on the CPU: the config
rules, the oracle, native CPU and hybrid engines, and the routing of
`compute_msm`, `compute_msm_batch` and `MSMPlan` over every engine
(tests/test_torch_ladders.py holds the naive and baseline engines).

The JAX `cpu_engine` is called on the port's build of the native library:
its source is the same file byte for byte (checked below), and a second g++
build of it would only cost the suite time. The JAX hybrid is called
without a device share only: its device share compiles the JAX device
pipeline on XLA:CPU for minutes; the JAX package's own test holds that
split against its oracle. All comparisons are exact.
"""
import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import webgpu_msm_tpu as jm
from webgpu_msm_tpu import config as jconfig
from webgpu_msm_tpu.engines import cpu_engine as jcpu
from webgpu_msm_tpu.oracle import msm as jmsm

import webgpu_msm_tpu_torch as tm
from webgpu_msm_tpu_torch import MSMConfig
from webgpu_msm_tpu_torch.api import HOST_ENGINES
from webgpu_msm_tpu_torch import config as tconfig
from webgpu_msm_tpu_torch.engines import cpu_engine, gpu_engine, hybrid_engine
from webgpu_msm_tpu_torch.oracle import curve, field, testdata
from webgpu_msm_tpu_torch.oracle.curve import ExtPoint
from webgpu_msm_tpu_torch.runtime import NativeBuildError
from webgpu_msm_tpu_torch.runtime import build as native_build
from webgpu_msm_tpu_torch.utils import convert, fixtures

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

REPO = Path(__file__).resolve().parents[1]
SPLIT = dict(window_size=8, cpu_work_ratio=0.25, n_chunks=8, chunk_len=8)  # n_gpu 72: two batches


def as_tuples(points):
    """Points as (x, y, t, z) tuples: the JAX API takes only its own
    `ExtPoint` class or plain tuples."""
    return [(p.x, p.y, p.t, p.z) for p in points]


def xy(res):
    return (res.x, res.y)


@pytest.fixture(scope="module")
def case():
    """96 distinct points and scalars, as lists and wire rows, and the JAX
    oracle's result."""
    pts = fixtures.distinct_points_fast(96, seed=21)
    scalars = fixtures.random_scalars(96, seed=22)
    want = curve.to_affine(jmsm.msm(pts, scalars, 8))
    return pts, scalars, fixtures.wire_points(pts), convert.bigints_to_u32_be(scalars), want


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX `cpu_engine`, loading the port's build of the same source.
    Its native calls set the process's OpenMP thread count, which PyTorch
    shares; PyTorch's count is put back afterwards, as the port's engine
    does itself."""
    jbuild = importlib.import_module("webgpu_msm_tpu.runtime.build")
    monkeypatch.setattr(jbuild, "_lib", native_build.load())
    threads = torch.get_num_threads()
    yield jcpu
    torch.set_num_threads(threads)


def scaled(points, seed):
    """The same points with random z != 1 (x, y, t, z all times z)."""
    rng = np.random.default_rng(seed)
    out = []
    for p in points:
        z = int(rng.integers(2, 1 << 62))
        out.append(ExtPoint(p.x * z % field.P, p.y * z % field.P, p.t * z % field.P, z))
    return out


# ---- config ----------------------------------------------------------------

def test_config_fields_match_jax():
    """The JAX fields and defaults, every one (`collective_mode` with the
    multi-GPU layer)."""
    port = {f.name: f.default for f in dataclasses.fields(MSMConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jconfig.MSMConfig)}
    assert port == ref
    cfg = MSMConfig(cpu_work_ratio=0.2, cpu_threads=2)
    assert (cfg.cpu_work_ratio, cfg.cpu_threads) == (0.2, 2)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("overrides", [{}, dict(window_size=10, n_chunks=4, chunk_len=8)])
def test_config_rules_match_jax(signed, overrides):
    t = MSMConfig(signed_digits=signed, **overrides)
    j = jconfig.MSMConfig(signed_digits=signed, **overrides)
    for n in sorted({(1 << k) + d for k in range(23) for d in (-1, 0, 1)} - {0}):
        assert tconfig.best_window_size(n) == jconfig.best_window_size(n), n
        assert tconfig.best_window_size_signed(n) == jconfig.best_window_size_signed(n), n
        assert tconfig.default_chunking(n) == jconfig.default_chunking(n), n
        assert t.resolved_window_size(n) == j.resolved_window_size(n), n
        assert t.resolved_window_size_native(n) == j.resolved_window_size_native(n), n
        assert t.resolved_chunking(n) == j.resolved_chunking(n), n
        assert t.resolved_wire_plan(n) == j.resolved_wire_plan(n), n
    with pytest.raises(ValueError):
        tconfig.default_chunking(0)


@pytest.mark.parametrize("w", [7, 21])
def test_window_range_checks(w):
    """`resolved_window_size` rejects w outside 8-20 in both packages and
    `resolved_window_size_native` in neither; `resolved_wire_plan` rejects
    it in the port only, a deliberate difference (the JAX one takes it)."""
    t, j = MSMConfig(window_size=w), jconfig.MSMConfig(window_size=w)
    for cfg in (t, j):
        with pytest.raises(ValueError, match="unsupported window size"):
            cfg.resolved_window_size(64)
        assert cfg.resolved_window_size_native(64) == w
    with pytest.raises(ValueError, match="unsupported window size"):
        t.resolved_wire_plan(64)
    assert j.resolved_wire_plan(64)[0] == w


# ---- oracle and native CPU engines ------------------------------------------

def test_oracle_engine_matches_jax(case, monkeypatch):
    """Default config: w = resolved_window_size(96) = 12 in both. The host
    engines resolve no device: no GPU and no `device` is no error."""
    pts, scalars, _, _, want = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = tm.compute_msm(pts, scalars, engine="oracle")
    ref = jm.compute_msm(as_tuples(pts), scalars, engine="oracle")
    assert xy(got) == xy(ref) == want


def test_native_source_is_the_jax_copy():
    port = REPO / "webgpu_msm_tpu_torch/runtime/csrc/msm_cpu.cpp"
    assert port.read_bytes() == (REPO / "webgpu_msm_tpu/runtime/csrc/msm_cpu.cpp").read_bytes()
    assert native_build.SOURCE == port.resolve()


@pytest.mark.parametrize("w", [8, 10, 13, 16])
def test_native_engine_matches_jax_cpu_engine(case, jax_native, w):
    pts, scalars, pw, sw, want = case
    assert cpu_engine.msm_window_partial(pts, scalars, w, 2) == want
    assert jax_native.msm_window_partial(pts, scalars, w, 2) == want
    assert cpu_engine.msm_wire(pw, sw, w, 2) == jax_native.msm_wire(pw, sw, w, 2) == want
    if w == 8:  # points with z != 1 are normalized on the host
        z_pts = scaled(pts, seed=5)
        assert cpu_engine.msm_window_partial(z_pts, scalars, w, 1) == want
        assert jax_native.msm_window_partial(z_pts, scalars, w, 1) == want
        np.testing.assert_array_equal(cpu_engine._be_rows_to_limbs4(sw), jcpu._be_rows_to_limbs4(sw))


def test_cpu_engine_entry_point(case, monkeypatch):
    pts, scalars, _, _, want = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = tm.compute_msm(pts, scalars, config=MSMConfig(window_size=8, cpu_threads=2), engine="cpu")
    assert xy(got) == want
    for cfg, co in ((MSMConfig(), False), (MSMConfig(), True), (MSMConfig(cpu_threads=3), True)):
        j = jconfig.MSMConfig(cpu_threads=cfg.cpu_threads)
        assert cpu_engine.resolved_threads(cfg, co) == jcpu.resolved_threads(j, co)


@pytest.mark.parametrize("engine", ["cpu", "hybrid"])
def test_native_calls_keep_torch_thread_count(case, engine):
    """The native library and PyTorch share one OpenMP runtime: an engine
    call that runs it leaves PyTorch's CPU thread count as it found it
    (with 8 OpenMP threads left behind, each small CPU op of every later
    call forks them)."""
    pts, scalars, _, _, want = case
    cfg = MSMConfig(window_size=8, cpu_work_ratio=1.0 if engine == "hybrid" else 0.0, cpu_threads=3)
    before = torch.get_num_threads()
    assert xy(tm.compute_msm(pts, scalars, config=cfg, device="cpu", engine=engine)) == want
    assert torch.get_num_threads() == before == 1


def test_add_affine_identity_and_doubling(jax_native):
    b = testdata.base_point()
    a = curve.to_affine(b)
    two = curve.to_affine(curve.double(b))
    three = curve.to_affine(curve.add(curve.double(b), b))
    assert cpu_engine.add_affine(a, (0, 1)) == jax_native.add_affine(a, (0, 1)) == a
    assert cpu_engine.add_affine(a, a) == jax_native.add_affine(a, a) == two
    assert cpu_engine.add_affine(a, two) == jax_native.add_affine(a, two) == three


# ---- hybrid -----------------------------------------------------------------

@pytest.mark.parametrize("form", ["wire", "list"])
def test_hybrid_split_matches_jax_oracle(case, form, monkeypatch):
    """n_cpu = int(96 * 0.25) = 24 points natively, 72 on the device path
    (two batches of 64)."""
    pts, scalars, pw, sw, want = case
    P, S = (pw, sw) if form == "wire" else (pts, scalars)
    shares = []
    for mod, name in ((cpu_engine, "msm_wire"), (gpu_engine, "msm_affine_wire")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda p, *a, _fn=fn, _n=name: shares.append(
            (_n, len(p))) or _fn(p, *a))
    got = tm.compute_msm(P, S, config=MSMConfig(**SPLIT), device="cpu", engine="hybrid")
    assert xy(got) == want
    assert sorted(shares) == [("msm_affine_wire", 72), ("msm_wire", 24)]  # lists as wire rows


@pytest.mark.parametrize("form", ["wire", "list"])
def test_hybrid_cpu_only_matches_jax_hybrid(case, form, jax_native):
    pts, scalars, pw, sw, want = case
    cfg = dict(window_size=8, cpu_work_ratio=1.0)
    P, S, JP = (pw, sw, pw) if form == "wire" else (pts, scalars, as_tuples(pts))
    got = tm.compute_msm(P, S, config=MSMConfig(**cfg), device="cpu", engine="hybrid")
    ref = jm.compute_msm(JP, S, config=jconfig.MSMConfig(**cfg), engine="hybrid")
    assert xy(got) == xy(ref) == want


def test_hybrid_wire_inputs_are_checked_at_the_api(case, monkeypatch):
    """The hybrid checks nothing itself: the API's check rejects rows with
    z != 1, which reach the hybrid marshalled, with z == 1, and give the
    same MSM; a length mismatch raises in the API."""
    _, _, pw, sw, want = case
    bad = pw.copy()
    bad[3, 31] = 2
    assert tm.api._wire_inputs(bad, sw) is None
    seen = []
    monkeypatch.setattr(hybrid_engine, "msm_affine_wire",
                        lambda p, *a, _f=hybrid_engine.msm_affine_wire: (seen.append(p), _f(p, *a))[1])
    z_not_one = fixtures.wire_points(scaled(fixtures.distinct_points_fast(96, seed=21), seed=24))
    assert tm.compute_msm(z_not_one, sw, config=MSMConfig(**SPLIT), device="cpu", engine="hybrid") == \
        tm.AffinePoint(*want)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], pw)
    with pytest.raises(ValueError, match="mismatch"):
        tm.compute_msm(pw, sw[:-1], config=MSMConfig(**SPLIT), device="cpu", engine="hybrid")
    assert len(seen) == 1


# ---- routing ---------------------------------------------------------------

ROUTE_SPLIT = dict(window_size=8, cpu_work_ratio=0.25, n_chunks=4, chunk_len=8)  # n_gpu 18: one batch


@pytest.mark.parametrize("engine,cfg", [
    ("oracle", MSMConfig(window_size=8)),
    ("cpu", MSMConfig(window_size=8)),
    ("hybrid", MSMConfig(**ROUTE_SPLIT)),
    ("gpu", MSMConfig(**ROUTE_SPLIT)),
])
def test_plan_and_batch_route_per_call(case, engine, cfg, monkeypatch):
    """No resident plan off the GPU engine or with a split: `MSMPlan` and
    `compute_msm_batch` give per-call `compute_msm`'s results, and the GPU
    engine with `cpu_work_ratio` > 0 is the hybrid."""
    pts, scalars, pw, sw, _ = case
    pw, jobs = pw[:24], [sw[:24], convert.bigints_to_u32_be(fixtures.random_scalars(24, seed=23))]
    calls = []
    real = hybrid_engine.msm_affine_wire
    monkeypatch.setattr(hybrid_engine, "msm_affine_wire", lambda *a: calls.append(1) or real(*a))
    want = [tm.compute_msm(pw, s, config=cfg, device="cpu", engine=engine) for s in jobs]
    assert len(calls) == (2 if engine in ("hybrid", "gpu") else 0)
    assert xy(want[0]) == curve.to_affine(jmsm.msm(pts[:24], scalars[:24], 8))
    monkeypatch.setattr(gpu_engine, "WirePlan", None)  # building one would raise
    plan = tm.MSMPlan(pw, config=cfg, device="cpu", engine=engine)
    assert plan._plan is None and plan.n == 24
    assert plan.msm_batch(jobs) == want
    assert tm.compute_msm_batch([pw, pw], jobs, config=cfg, device="cpu", engine=engine) == want
    if engine in HOST_ENGINES:
        assert tm.MSMPlan(pts[:24], config=cfg, engine=engine).msm(jobs[1]) == want[1]


@pytest.mark.parametrize("engine", ["tpu", "metal"])
def test_unknown_engine_raises(case, engine):
    _, _, pw, sw, _ = case
    with pytest.raises(ValueError, match="the port's engines"):
        tm.compute_msm(pw, sw, device="cpu", engine=engine)
    with pytest.raises(ValueError, match="the port's engines"):
        tm.compute_msm_batch([pw], [sw], device="cpu", engine=engine)
    with pytest.raises(ValueError, match="the port's engines"):
        tm.MSMPlan(pw, device="cpu", engine=engine)


@pytest.mark.parametrize("engine", ["naive", "baseline", "hybrid", "gpu"])
def test_device_engines_need_a_device(case, engine, monkeypatch):
    """Without a GPU a device engine raises unless device="cpu" is given."""
    pts, scalars, pw, sw, _ = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for P, S in ((pts[:4], scalars[:4]), (pw, sw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.compute_msm(P, S, engine=engine)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.compute_msm_batch([pw], [sw], engine=engine)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.MSMPlan(pw, engine=engine)


@pytest.mark.parametrize("fault", ["no compiler", "failing compile", "hanging compile"])
def test_native_build_failure_raises(case, fault, monkeypatch, tmp_path):
    """No fallback to the oracle: without a working g++ the native engines
    raise `NativeBuildError`; so does a compiler that outlasts the build's
    time limit."""
    pts, scalars, _, _, _ = case
    monkeypatch.setattr(native_build, "_lib", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    if fault == "no compiler":
        monkeypatch.setattr(native_build, "CXX", "g++-that-is-not-installed")
    elif fault == "failing compile":
        monkeypatch.setattr(native_build, "CXX_FLAGS", native_build.CXX_FLAGS + ("-fno-such-flag",))
    else:  # a compiler that sleeps 30 s, stopped after 0.5 s
        monkeypatch.setattr(native_build, "CXX", "sh")
        monkeypatch.setattr(native_build, "CXX_FLAGS", ("-c", "exec sleep 30"))
        monkeypatch.setattr(native_build, "BUILD_TIMEOUT_S", 0.5)
    with pytest.raises(NativeBuildError):
        tm.compute_msm(pts[:4], scalars[:4], engine="cpu")
    with pytest.raises(NativeBuildError):
        tm.compute_msm(pts[:4], scalars[:4], device="cpu", engine="hybrid",
                       config=MSMConfig(cpu_work_ratio=1.0))
    assert list(tmp_path.iterdir()) == []  # no partial library left behind
