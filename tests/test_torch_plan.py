"""The port's fixed-base plan and batch entry points against the JAX
package's: `WirePlan`, `MSMPlan`, `compute_msm_batch`, and the interop
function that carries a JAX plan's resident bases into the port.

The JAX plan runs its jobs op by op under `jax.disable_jit()`, once for
the whole file; all comparisons are exact.
"""
import jax
import numpy as np
import pytest
import torch

from webgpu_msm_tpu import api as japi
from webgpu_msm_tpu import config as jconfig
from webgpu_msm_tpu.engines import tpu_engine as te
from webgpu_msm_tpu.oracle import curve as joc
from webgpu_msm_tpu.oracle import field as F
from webgpu_msm_tpu.oracle import msm as jmsm

import webgpu_msm_tpu_torch as tm
from webgpu_msm_tpu_torch import MSMConfig
from webgpu_msm_tpu_torch import api
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.ops import pippenger
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle.curve import ExtPoint
from webgpu_msm_tpu_torch.utils import convert, fixtures
from webgpu_msm_tpu_torch.utils.interop import (
    planes_from_numpy, planes_to_numpy, wire_plan_from_jax_state)

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

N = 13  # pads to 16: one batch of C * L = 16, or two of 8
STATIC = dict(window_size=8, n_chunks=4, chunk_len=4)
CFG = MSMConfig(**STATIC)
CFG_2_BATCHES = MSMConfig(window_size=8, n_chunks=2, chunk_len=4)


@pytest.fixture(scope="module")
def case():
    """13 bases as wire rows, three scalar jobs, the oracle's results."""
    pts = fixtures.distinct_points_fast(N, seed=91)
    jobs = [fixtures.random_scalars(N, seed=92 + j) for j in range(3)]
    jobs[1][:3] = [0, 1, F.P - 1]
    jobs[2][0] = 1 << 254  # too large for signed digits: this job runs unsigned
    want = [joc.to_affine(jmsm.msm(pts, sc, 8)) for sc in jobs]
    return pts, jobs, fixtures.wire_points(pts), [convert.bigints_to_u32_be(sc) for sc in jobs], want


@pytest.fixture(scope="module")
def jax_plan(case):
    """The JAX `WirePlan` of the bases and its results for jobs 0 and 1."""
    _, _, pw, sws, _ = case
    with jax.disable_jit():
        plan = te.WirePlan(pw, jconfig.MSMConfig(**STATIC))
        results = plan.msm_affine_batch(sws[:2])
    return plan, results


def xy(results) -> list:
    return [(r.x, r.y) for r in results]


def test_wire_plan_matches_jax(case, jax_plan):
    _, _, pw, sws, want = case
    jplan, jresults = jax_plan
    plan = gpu_engine.WirePlan(pw, CFG, "cpu")
    for name in ("n", "w", "C", "L", "pad_to"):
        assert getattr(plan, name) == getattr(jplan, name), name
    assert len(plan._rows) == len(jplan._niels) == 1
    for a, b in zip(plan._rows, jplan._niels):  # the JAX Niels planes as the scan's rows
        np.testing.assert_array_equal(planes_to_numpy(a), planes_to_numpy(pippenger.pack_rows(
            planes_from_numpy(np.asarray(b)))))
    assert plan.msm_affine_batch(sws[:2]) == jresults == want[:2]
    assert plan.msm_affine(sws[2]) == want[2]


def test_plan_from_jax_state_runs_the_jobs(case, jax_plan):
    """Bases built once in JAX serve scalar jobs in the port."""
    _, _, _, sws, want = case
    jplan, jresults = jax_plan
    plan = wire_plan_from_jax_state(
        [np.asarray(a) for a in jplan._niels], n=jplan.n, w=jplan.w, C=jplan.C, L=jplan.L,
        pad_to=jplan.pad_to, config=CFG, device="cpu",
    )
    assert isinstance(plan, gpu_engine.WirePlan) and plan._rows[0].dtype == torch.int32
    assert plan.msm_affine_batch(sws[:2]) == jresults == want[:2]
    with pytest.raises(ValueError, match="do not match"):
        wire_plan_from_jax_state([np.asarray(jplan._niels[0])], n=N, w=8, C=2, L=4, pad_to=16,
                                 config=CFG, device="cpu")


def test_dispatch_queues_without_fetching(case):
    """`dispatch` returns the finish stage's tensor on the plan's device;
    the affine finish gives the [2, 16, K] layout."""
    _, _, pw, sws, want = case
    out, w = gpu_engine.WirePlan(pw, CFG, "cpu").dispatch(sws[0])
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (4, 16, 32) and w == 8
    plan = gpu_engine.WirePlan(pw, MSMConfig(device_affine=True, **STATIC), "cpu")
    out, w = plan.dispatch(sws[0])
    assert tuple(out.shape) == (2, 16, 32)
    assert gpu_engine._fetch_affine(out, w) == want[0]


def test_bases_are_converted_once(case, monkeypatch):
    """`to_niels_xy_rows` runs once per base batch at construction and
    never for a job; two batches give the one-batch plan's results."""
    _, _, pw, sws, want = case
    calls = []
    monkeypatch.setattr(pk, "to_niels_xy_rows",
                        lambda t, f=pk.to_niels_xy_rows: (calls.append(1), f(t))[1])
    plan = gpu_engine.WirePlan(pw, CFG_2_BATCHES, "cpu")
    assert len(calls) == len(plan._rows) == 2
    assert plan.msm_affine_batch(sws[1:]) == want[1:]
    assert len(calls) == 2


def test_plan_input_checks(case, monkeypatch):
    _, jobs, pw, sws, want = case
    plan = tm.MSMPlan(pw, config=CFG, device="cpu")
    for short in (sws[0][:-1], jobs[0][:-1]):
        with pytest.raises(ValueError, match="13 bases"):
            plan.msm(short)
    bad = pw.copy()
    bad[2, 31] = 2  # z == 2 without scaling x, y, t: rejected by the API's check, then marshalled
    assert api._wire_point_rows(bad) is None
    marshalled = api._points_to_wire(api._normalize_points(bad))
    assert (marshalled[:, 24:31] == 0).all() and (marshalled[:, 31] == 1).all()
    np.testing.assert_array_equal(np.delete(marshalled, 2, axis=0), np.delete(pw, 2, axis=0))
    assert torch.equal(tm.MSMPlan(bad, config=CFG, device="cpu")._plan._rows[0],
                       gpu_engine.WirePlan(marshalled, CFG, "cpu")._rows[0])
    split = MSMConfig(window_size=8, cpu_work_ratio=0.25, n_chunks=4, chunk_len=4)
    for engine, cfg in (("oracle", CFG), ("cpu", CFG), ("naive", CFG), ("baseline", CFG),
                        ("hybrid", split)):
        got = tm.MSMPlan(pw, config=cfg, device="cpu", engine=engine).msm(sws[0])
        assert (got.x, got.y) == want[0], engine
        [got] = tm.compute_msm_batch([pw], [sws[1]], config=cfg, device="cpu", engine=engine)
        assert (got.x, got.y) == want[1], engine
    with pytest.raises(ValueError, match="unknown engine 'tpu'"):
        tm.MSMPlan(pw, config=CFG, device="cpu", engine="tpu")
    with pytest.raises(ValueError, match="unknown engine 'tpu'"):
        tm.compute_msm_batch([pw], [sws[0]], config=CFG, device="cpu", engine="tpu")
    with pytest.raises(ValueError, match="length mismatch"):
        tm.compute_msm_batch([pw, pw], [sws[0]], config=CFG, device="cpu")
    assert tm.compute_msm_batch([], [], device="cpu") == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.MSMPlan(pw, config=CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.compute_msm_batch([pw], [sws[0]], config=CFG)


@pytest.mark.parametrize("form", ["wire-rows", "ext-points", "wire-rows-z-not-1"])
def test_msm_plan_matches_oracle(case, form):
    """`MSMPlan` on wire rows, and on forms it first marshals to wire rows;
    scalars as arrays and as lists of ints."""
    pts, jobs, pw, sws, want = case
    lam = 7
    points = {
        "wire-rows": pw,
        "ext-points": pts,
        "wire-rows-z-not-1": fixtures.wire_points(
            [ExtPoint(p.x * lam % F.P, p.y * lam % F.P, p.t * lam % F.P, lam) for p in pts]),
    }[form]
    plan = tm.MSMPlan(points, config=CFG, device="cpu")
    assert plan.n == N
    assert xy(plan.msm_batch([jobs[1], sws[2]])) == want[1:]
    if form == "wire-rows":
        assert plan.msm(jobs[0]) == tm.AffinePoint(*want[0])


def test_msm_plan_marshal_matches_jax(case):
    """The one host marshal of a plan over list input gives the rows the
    JAX `MSMPlan` builds its plan from."""
    pts, _, pw, _, _ = case
    scaled = [ExtPoint(p.x * 3 % F.P, p.y * 3 % F.P, p.t * 3 % F.P, 3) for p in pts]
    rows = api._points_to_wire(scaled)
    np.testing.assert_array_equal(rows, pw)
    seen = []

    class Recorder:
        n = N

        def __init__(self, rows, config):
            seen.append(rows)

    orig, te.WirePlan = te.WirePlan, Recorder
    try:
        japi.MSMPlan([joc.ExtPoint(p.x, p.y, p.t, p.z) for p in scaled], engine="tpu")
    finally:
        te.WirePlan = orig
    np.testing.assert_array_equal(seen[0], rows)


BATCH_KINDS = ["shared-bases", "distinct-arrays", "one-wire-job", "lists", "mixed"]


def batch_inputs(case, kind):
    pts, jobs, pw, sws, _ = case
    return {
        "shared-bases": ([pw, pw], sws[1:]),
        "distinct-arrays": ([pw, pw.copy()], sws[1:]),
        "one-wire-job": ([pw], sws[1:2]),
        "lists": ([pts, pts], jobs[1:]),
        "mixed": ([pw, pts], [sws[1], jobs[2]]),
    }[kind]


@pytest.mark.parametrize("kind", BATCH_KINDS)
def test_compute_msm_batch_matches_oracle(case, kind):
    points_list, scalars_list = batch_inputs(case, kind)
    got = tm.compute_msm_batch(points_list, scalars_list, config=CFG, device="cpu")
    assert xy(got) == case[4][1 : 1 + len(points_list)]


@pytest.mark.parametrize("kind", BATCH_KINDS)
def test_compute_msm_batch_routes_as_jax(case, kind, monkeypatch):
    """Which engine entry point takes the batch. JAX: the plan for one
    shared point array, the batched wire path for wire jobs, the planes
    path for anything else. The port: the plan for one shared point
    object of any form, else the batched wire path, lists marshalled to
    wire rows first. Both packages' engines are replaced by recorders."""
    points_list, scalars_list = batch_inputs(case, kind)
    n = len(points_list)

    def recorders(engine, seen):
        class Plan:
            def __init__(self, *args):
                seen.append("plan")

            def msm_affine_batch(self, scalars):
                return [(0, 1)] * len(scalars)

        monkeypatch.setattr(engine, "WirePlan", Plan)
        monkeypatch.setattr(engine, "msm_affine_batch_wire",
                            lambda jobs, *a: (seen.append("wire"), [(0, 1)] * len(jobs))[1])
        if engine is te:
            monkeypatch.setattr(engine, "msm_affine_batch",
                                lambda jobs, *a: (seen.append("planes"), [(0, 1)] * len(jobs))[1])

    jseen, tseen = [], []
    recorders(te, jseen)
    recorders(gpu_engine, tseen)
    if kind in ("lists", "mixed"):  # the JAX api knows only its own ExtPoint
        points_list = [p if isinstance(p, np.ndarray) else [joc.ExtPoint(q.x, q.y, q.t, q.z) for q in p]
                       for p in points_list]
    assert len(japi.compute_msm_batch(points_list, scalars_list, engine="tpu")) == n
    assert len(tm.compute_msm_batch(batch_inputs(case, kind)[0], scalars_list, device="cpu")) == n
    want = {"shared-bases": "plan", "distinct-arrays": "wire", "one-wire-job": "wire",
            "lists": "planes", "mixed": "planes"}[kind]
    assert jseen == [want]
    assert tseen == [{"lists": "plan", "mixed": "wire"}.get(kind, want)]  # [pts, pts]: one object


def test_msm_affine_batch_queues_every_job_before_fetching(case, monkeypatch):
    pts, jobs, pw, sws, want = case
    events = []
    for name in ("_dispatch_wire", "_fetch_affine"):
        monkeypatch.setattr(gpu_engine, name,
                            lambda *a, _f=getattr(gpu_engine, name), _n=name: (events.append(_n), _f(*a))[1])
    dev = torch.device("cpu")
    got = tm.compute_msm_batch([pts, list(pts)], jobs[:2], config=CFG, device="cpu")  # two list objects
    assert xy(got) == want[:2]
    assert gpu_engine.msm_affine_batch_wire([(pw, sws[0]), (pw, sws[1])], CFG, dev) == want[:2]
    assert events == (["_dispatch_wire"] * 2 + ["_fetch_affine"] * 2) * 2
