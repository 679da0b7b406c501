"""The port end to end on the CPU: `compute_msm` against the JAX package's
and the oracle, the API's input handling, the port's own copies of the
oracle, fixtures and plan rule, and its import boundary.

JAX's `compute_msm` runs op by op under `jax.disable_jit()`: the same
integer operations as its jitted stages, without minutes of XLA:CPU
compile.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import webgpu_msm_tpu as jm
from webgpu_msm_tpu import config as jconfig
from webgpu_msm_tpu.oracle import curve as joc
from webgpu_msm_tpu.oracle import field as jF
from webgpu_msm_tpu.oracle import msm as jmsm
from webgpu_msm_tpu.oracle import pinned_vectors as jpinned
from webgpu_msm_tpu.oracle import testdata as jtestdata
from webgpu_msm_tpu.utils import convert as jconvert
from webgpu_msm_tpu.utils import fixtures as jfixtures

import webgpu_msm_tpu_torch as tm
from webgpu_msm_tpu_torch import MSMConfig
from webgpu_msm_tpu_torch.oracle import curve, field, msm, pinned_vectors, testdata
from webgpu_msm_tpu_torch.utils import convert, fixtures

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

REPO = Path(__file__).resolve().parents[1]
CFG = MSMConfig(window_size=8, n_chunks=8, chunk_len=8)


@pytest.fixture(scope="module")
def case():
    """48 distinct points and scalars, as wire rows and as the oracle's
    result."""
    pts = fixtures.distinct_points_fast(48, seed=51)
    scalars = fixtures.random_scalars(48, seed=52)
    want = joc.to_affine(jmsm.msm(pts, scalars, 8))
    return pts, scalars, fixtures.wire_points(pts), convert.bigints_to_u32_be(scalars), want


def test_compute_msm_matches_jax_and_oracle(case):
    _, _, pw, sw, want = case
    with jax.disable_jit():
        ref = jm.compute_msm(pw, sw, config=jconfig.MSMConfig(window_size=8, n_chunks=8, chunk_len=8),
                             engine="tpu")
    assert (ref.x, ref.y) == want
    got = tm.compute_msm(pw, sw, config=CFG, device="cpu")
    assert (got.x, got.y) == want


@pytest.mark.parametrize("cfg", [
    MSMConfig(window_size=8, n_chunks=4, chunk_len=4),  # 3 batches
    MSMConfig(window_size=8, n_chunks=4, chunk_len=4, signed_digits=False),
    MSMConfig(window_size=9, n_chunks=2, chunk_len=8),  # padding: 48 -> 3 x 16
], ids=["signed-3-batches", "unsigned-3-batches", "w9-padded"])
def test_compute_msm_several_batches(case, cfg):
    _, _, pw, sw, want = case
    got = tm.compute_msm(pw, sw, config=cfg, device="cpu")
    assert (got.x, got.y) == want


def test_list_inputs_and_z_not_one(case):
    """Lists, and wire rows with z != 1, are marshalled by the API to wire
    rows, the host normalizing z."""
    pts, scalars, pw, sw, want = case
    got = tm.compute_msm(pts[:37], scalars[:37], config=CFG, device="cpu")
    assert (got.x, got.y) == joc.to_affine(jmsm.msm(pts[:37], scalars[:37], 8))
    xy = [(p.x, p.y) for p in pts]
    assert tm.compute_msm(xy, sw, config=CFG, device="cpu") == tm.AffinePoint(*want)
    lam = 7
    scaled = [curve.ExtPoint(p.x * lam % field.P, p.y * lam % field.P, p.t * lam % field.P, lam)
              for p in pts]
    got = tm.compute_msm(fixtures.wire_points(scaled), sw, config=CFG, device="cpu")
    assert (got.x, got.y) == want


def test_input_checks(case):
    _, _, pw, sw, _ = case
    assert tm.compute_msm(pw[:0], sw[:0], device="cpu") == tm.AffinePoint(0, 1)
    with pytest.raises(ValueError, match="mismatch"):
        tm.compute_msm(pw, sw[:-1], device="cpu")
    with pytest.raises(ValueError, match="u32"):
        tm.compute_msm(pw.astype(np.uint64) + (1 << 32), sw, device="cpu")
    as_dict = {c: pw[:2, 8 * i : 8 * i + 8] for i, c in enumerate("xytz")}
    assert tm.compute_msm(as_dict, [3, 0], config=CFG, device="cpu") == \
        tm.compute_msm(pw[:1], np.array([[0] * 7 + [3]], dtype=np.uint32), config=CFG, device="cpu")
    with pytest.raises(KeyError):
        tm.compute_msm({"x": pw[:, :8]}, sw, device="cpu")
    _, _, _, _, want = case
    split = MSMConfig(window_size=8, cpu_work_ratio=0.25, n_chunks=4, chunk_len=8)
    for engine, cfg in (("oracle", CFG), ("cpu", CFG), ("naive", CFG), ("baseline", CFG),
                        ("hybrid", split)):
        got = tm.compute_msm(pw, sw, config=cfg, device="cpu", engine=engine)
        assert (got.x, got.y) == want, engine
    with pytest.raises(ValueError, match="unknown engine 'tpu'"):
        tm.compute_msm(pw, sw, device="cpu", engine="tpu")


def test_no_gpu_and_no_device_raises(case, monkeypatch):
    """Without a card the entry point refuses to carry on quietly on the CPU."""
    _, _, pw, sw, _ = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.compute_msm(pw, sw)


def coords(p) -> tuple:
    """An ExtPoint of either package as a plain tuple."""
    return (p.x, p.y, p.t, p.z)


def test_oracle_copies_match_jax():
    for name in ("P", "EDWARDS_D", "SUBGROUP_ORDER", "R_MOD_P", "R2_MOD_P", "N0_INV_16", "N0_INV_32"):
        assert getattr(field, name) == getattr(jF, name), name
    assert pinned_vectors.PINNED == jpinned.PINNED
    assert coords(testdata.base_point()) == coords(jtestdata.base_point())
    pts = jfixtures.distinct_points_fast(9, seed=3)
    pairs = list(zip(pts, pts[1:]))
    assert [coords(curve.add(p, q)) for p, q in pairs] == [coords(joc.add(p, q)) for p, q in pairs]
    assert [coords(curve.double(p)) for p in pts] == [coords(joc.double(p)) for p in pts]
    assert coords(msm.combine_windows(pts, 13)) == coords(jmsm.combine_windows(pts, 13))
    sc = jfixtures.random_scalars(9, seed=4)
    assert coords(msm.msm(pts, sc, 8)) == coords(jmsm.msm(pts, sc, 8))


def test_fixtures_and_convert_match_jax():
    assert fixtures.random_scalars(50, seed=1016) == jfixtures.random_scalars(50, seed=1016)
    assert list(map(coords, fixtures.distinct_points_fast(20, seed=16))) == \
        list(map(coords, jfixtures.distinct_points_fast(20, seed=16)))
    vals = fixtures.random_scalars(10, seed=2) + [0, (1 << 256) - 1]
    be = convert.bigints_to_u32_be(vals)
    np.testing.assert_array_equal(be, jconvert.bigints_to_u32_be(vals))
    np.testing.assert_array_equal(convert.be_rows_to_words_le(be), jconvert.be_rows_to_words_le(be))
    assert convert.words_le_to_bigints(convert.be_rows_to_words_le(be)) == vals
    wide = be.astype(np.int64)
    np.testing.assert_array_equal(convert.as_u32_array(wide), be)
    with pytest.raises(ValueError):
        convert.as_u32_array(wide - 1 - wide.max())


@pytest.mark.parametrize("n", [1, 48, 1 << 12, 1 << 16, (1 << 16) + 1, 1 << 18, 1 << 20])
@pytest.mark.parametrize("signed", [False, True])
def test_wire_plan_matches_jax(n, signed):
    assert MSMConfig(signed_digits=signed).resolved_wire_plan(n) == \
        jconfig.MSMConfig(signed_digits=signed).resolved_wire_plan(n)


def test_config_fields_keep_the_jax_defaults():
    ours, theirs = MSMConfig(), jconfig.MSMConfig()
    for name in ("window_size", "n_chunks", "chunk_len", "signed_digits", "device_affine"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.device_affine is False


def test_port_imports_no_jax():
    """The package, chip_smoke.py and bench_torch.py import neither jax nor
    any module of the JAX package."""
    code = (
        "import sys, webgpu_msm_tpu_torch, chip_smoke, bench_torch\n"
        "import webgpu_msm_tpu_torch.benchmark, webgpu_msm_tpu_torch.utils.trace\n"
        "import webgpu_msm_tpu_torch.engines.gpu_engine, webgpu_msm_tpu_torch.ops.kernels.build\n"
        "import webgpu_msm_tpu_torch.utils.interop, webgpu_msm_tpu_torch.utils.fixtures\n"
        "import webgpu_msm_tpu_torch.ops.kernels.field_kernels_mma, webgpu_msm_tpu_torch.ops.kernels.padd_kernels\n"
        "import webgpu_msm_tpu_torch.api, webgpu_msm_tpu_torch.ops.pippenger\n"
        "import webgpu_msm_tpu_torch.engines.hybrid_engine, webgpu_msm_tpu_torch.engines.naive_engine\n"
        "import webgpu_msm_tpu_torch.engines.baseline_engine, webgpu_msm_tpu_torch.runtime.build\n"
        "assert {'MSMPlan', 'compute_msm_batch'} <= set(dir(webgpu_msm_tpu_torch))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'webgpu_msm_tpu.'))"
        " or m == 'webgpu_msm_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
