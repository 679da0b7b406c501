"""The point kernels' plain versions against the JAX package, their
wrappers' routing, and the kernel build helpers (the matrix-form scan is in
tests/test_torch_mma.py).

On the CPU a wrapper runs its kernel's plain version; the CUDA kernels
themselves are held against the same plain versions on the card by
tests/test_torch_gpu.py.
"""
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.ops import curve_ops as jcurve
from webgpu_msm_tpu.oracle import curve as oc
from webgpu_msm_tpu.oracle import field as F
from webgpu_msm_tpu.utils import fixtures

from webgpu_msm_tpu_torch.ops.kernels import build
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.utils.interop import (
    affine_from_planes, mont_planes_from_points, planes_from_numpy, planes_to_numpy)

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

W = 20


def rand_planes(rng, lead, width):
    """Random field elements below p as [*lead, 16, width] uint32 digits."""
    d = rng.integers(0, 1 << 16, size=lead + (16, width), dtype=np.uint32)
    d[..., 15, :] %= 0x12AB  # p's top digit is 0x12ab
    return d


def jax_pts(st):
    return jcurve.PointVec.from_stacked(jnp.asarray(st))


def test_to_niels_xy_plain_matches_jax():
    rng = np.random.default_rng(1)
    xy = rng.integers(0, 1 << 16, size=(2, 16, W), dtype=np.uint32)  # raw words
    got = pk.to_niels_xy(planes_from_numpy(xy))
    want = jcurve.to_niels_from_xy(jnp.asarray(xy[0]), jnp.asarray(xy[1]))
    np.testing.assert_array_equal(planes_to_numpy(got), np.asarray(want))


def test_to_niels_plain_matches_jax():
    """Plain (x, y, t) below p, with 0 and p - 1 among them, against the
    JAX package's `to_niels_planes` and the oracle."""
    rng = np.random.default_rng(4)
    pts = rand_planes(rng, (3,), W)
    pts[:, :, 0] = 0
    pts[:, :, 1] = np.array([(F.P - 1 >> (16 * k)) & 0xFFFF for k in range(16)], np.uint32)
    got = planes_to_numpy(pk.to_niels(planes_from_numpy(pts)))
    np.testing.assert_array_equal(got, np.asarray(jcurve.to_niels_planes(jnp.asarray(pts))))
    assert got.shape == (3, 16, W) and pk.to_niels_plain(planes_from_numpy(pts)).dtype == torch.int32
    for i in (1, 5):
        x, y, t = (_ints(pts[c], i) for c in range(3))
        assert [_ints(got[c], i) for c in range(3)] == [
            (y - x) * F.R % F.P, (y + x) * F.R % F.P, 2 * F.EDWARDS_D * t * F.R % F.P]


def test_padd_plain_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rand_planes(rng, (4,), W), rand_planes(rng, (4,), W)
    got = pk.padd(planes_from_numpy(a), planes_from_numpy(b))
    want = jcurve.add(jax_pts(a), jax_pts(b)).stacked()
    np.testing.assert_array_equal(planes_to_numpy(got), np.asarray(want))


def test_padd_masked_plain_matches_jax():
    rng = np.random.default_rng(3)
    a, b = rand_planes(rng, (4,), W), rand_planes(rng, (4,), W)
    mask = rng.integers(0, 3, size=W).astype(np.uint32)  # any nonzero adds
    got = pk.padd_masked(planes_from_numpy(a), planes_from_numpy(b), planes_from_numpy(mask))
    pa = jax_pts(a)
    want = jcurve.select(jnp.asarray(mask != 0), jcurve.add(pa, jax_pts(b)), pa).stacked()
    np.testing.assert_array_equal(planes_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("Gs", [1, 3, 16])
def test_grouped_running_sum_plain_matches_jax_chain(Gs):
    """T = run after r = Gs-1..0; U adds run on every step but the last:
    the same sums as that chain of JAX curve_ops.add calls. The port adds
    in the order of its tree, and extended coordinates are not canonical,
    so the two agree as points, not digit for digit. Lane 0 is all identity,
    and lane 1 has identity elements."""
    n_lanes = 6
    pts = fixtures.distinct_points_fast(Gs * n_lanes, seed=80 + Gs)
    pts[:: n_lanes] = [oc.IDENTITY] * Gs
    pts[1] = oc.IDENTITY
    s = mont_planes_from_points(pts).reshape(4, 16, Gs, n_lanes).transpose(2, 0, 1, 3).copy()
    T, U = pk.grouped_running_sum(planes_from_numpy(s))
    run = u = jcurve.identity((n_lanes,))
    for i in range(Gs):
        run = jcurve.add(run, jax_pts(s[Gs - 1 - i]))
        if i != Gs - 1:
            u = jcurve.add(u, run)
    assert affine_from_planes(planes_to_numpy(T)) == affine_from_planes(np.asarray(run.stacked()))
    assert affine_from_planes(planes_to_numpy(U)) == affine_from_planes(np.asarray(u.stacked()))
    assert affine_from_planes(planes_to_numpy(T))[0] == oc.to_affine(oc.IDENTITY)


# ---- accumulate_scan against a per-lane Python model ----------------------

def _ints(planes, *idx):
    """Montgomery int of [..., 16, ...] digit planes at lane index idx."""
    return sum(int(planes[(k,) + idx]) << (16 * k) for k in range(16))


def _mmul(a, b):
    return a * b * pow(F.R, -1, F.P) % F.P


def _niels_add_model(acc, niels):
    x1, y1, t1, z1 = acc
    ym2, yp2, td2 = niels
    a = _mmul(F.fsub(y1, x1), ym2)
    b = _mmul(F.fadd(y1, x1), yp2)
    c = _mmul(t1, td2)
    d = F.fadd(z1, z1)
    e, f, g, h = F.fsub(b, a), F.fsub(d, c), F.fadd(d, c), F.fadd(b, a)
    return (_mmul(e, f), _mmul(g, h), _mmul(e, h), _mmul(f, g))


S = 1 << 31  # sign flag
SCAN_PATTERNS = [
    [5] * 8,                                  # one run
    [3] * 4 + [7] * 4,                        # one boundary
    [1, 1, 2, 2, 2, 6, 6, 6],                 # several boundaries
    list(range(8)),                           # a boundary every step
    [9, 9 | S, 9, 9 | S, 9, 9, 9 | S, 9],     # signs within one run
    [4 | S, 4, 2 | S, 2 | S, 2, 8, 8 | S, 1],  # signs and boundaries mixed
]


def test_accumulate_scan_plain_matches_model():
    L, n_lanes = 8, len(SCAN_PATTERNS)
    rng = np.random.default_rng(7)
    niels = rand_planes(rng, (3,), L * n_lanes).reshape(3, 16, L, n_lanes)
    packed = niels[:, 0::2] | (niels[:, 1::2] << 16)  # [3, 8, L, W]
    ids = np.array(SCAN_PATTERNS, dtype=np.uint32).T.copy()  # [L, W]
    facc, fid, staged = pk.accumulate_scan(planes_from_numpy(packed), planes_from_numpy(ids))
    facc, fid, staged = planes_to_numpy(facc), planes_to_numpy(fid), planes_to_numpy(staged)
    ident = (0, F.R_MOD_P, 0, F.R_MOD_P)
    for w in range(n_lanes):
        acc, acc_id = ident, 0xFFFFFFFF
        for l in range(L):
            raw = int(ids[l, w])
            bid, neg = raw & 0x7FFFFFFF, raw >> 31
            ym, yp, td = (_ints(niels[c], l, w) for c in range(3))
            if neg:
                ym, yp, td = yp, ym, F.fneg(td)
            assert tuple(_ints(staged[c], l, w) for c in range(4)) == acc, (w, l)
            if bid != acc_id:
                acc = ident
            acc = _niels_add_model(acc, (ym, yp, td))
            acc_id = bid
        assert int(fid[w]) == acc_id
        assert tuple(_ints(facc[c], w) for c in range(4)) == acc


# ---- wrapper routing and checks -------------------------------------------

def test_cpu_tensors_run_the_plain_version_without_counting():
    pk.reset_launch_counts()
    a = planes_from_numpy(rand_planes(np.random.default_rng(8), (4,), W))
    pk.padd(a, a)
    assert pk.launches == {name: 0 for name in pk.KERNELS}


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrappers_reject_bad_tensors(bad):
    a = planes_from_numpy(rand_planes(np.random.default_rng(9), (4,), W))
    b = a.clone()
    if bad == "dtype":
        a, exc = a.to(torch.int64), TypeError
    elif bad == "shape":
        a, exc = a[:3].contiguous(), ValueError
    elif bad == "contiguity":
        a, exc = torch.cat([a, a], dim=-1)[..., ::2], ValueError
    else:  # neither CPU nor CUDA: no plain fallback either
        a, b, exc = a.to("meta"), b.to("meta"), ValueError
    with pytest.raises(exc):
        pk.padd(a, b)


def test_every_kernel_has_a_count_and_a_plain_version():
    assert pk.KERNELS == ("to_niels_xy", "accumulate_scan", "padd_masked", "padd",
                          "grouped_running_sum", "to_niels", "accumulate_scan_mma",
                          "accumulate_scan_gather", "reduce_finish", "lane_scan",
                          "assemble_buckets", "to_niels_xy_rows", "accumulate_scan_gather_mma",
                          "finish_affine_divsteps")
    assert set(pk.launches) == set(pk.KERNELS)
    for name in pk.KERNELS:
        # a tensor-core scan is its CIOS scan's wrapper and plain version with use_mma
        base = name.replace("_mma", "")
        # the divstep finish computes the function of the JAX tail, `finish_affine_plain`
        plain = "finish_affine_plain" if base == "finish_affine_divsteps" else base + "_plain"
        assert callable(getattr(pk, base)) and callable(getattr(pk, plain))
        if base != name:
            for fn in (getattr(pk, base), getattr(pk, base + "_plain")):
                assert inspect.signature(fn).parameters["use_mma"].default is False


def test_signatures_cover_every_c_entry_point():
    """No compiler runs on the CPU host, so the ctypes table is held
    against the sources: every `launch_*` entry point, with one ctypes
    argument per C parameter, pointers as void pointers and sizes as ints."""
    found = {}
    for cu in sorted(build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (launch_\w+)\(([^)]*)\)', cu.read_text()):
            found[name] = tuple(
                build._I if prm.split()[0] == "int" else build._P for prm in params.split(",")
            )
    assert found == build.SIGNATURES
    kernels = {m for cu in build.CSRC.glob("*.cu")
               for m in re.findall(r"__global__ void\s+(?:__launch_bounds__\([\w, ]+\)\s+)?(\w+)\(",
                                   cu.read_text())}
    assert kernels == {name + "_kernel" for name in pk.KERNELS}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


def test_library_path_is_keyed_by_sources(monkeypatch, tmp_path):
    before = build.library_path()
    assert before.parent == build.BUILD_DIR and before.name.startswith("libmsm_kernels-")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    assert build.library_path() == before
    (csrc / "field.cuh").write_text((csrc / "field.cuh").read_text() + "\n// edit\n")
    assert build.library_path() != before


def test_ptxas_report_parses_the_build_log(monkeypatch, tmp_path):
    log = tmp_path / "libmsm_kernels-x.log"
    log.write_text(
        "ptxas info    : 0 bytes gmem, 128 bytes cmem[3]\n"
        "ptxas info    : Compiling entry function 'padd_kernel' for 'sm_90a'\n"
        "ptxas info    : Function properties for padd_kernel\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, 380 bytes cmem[0]\n"
    )
    monkeypatch.setattr(build, "library_path", lambda: log.with_suffix(".so"))
    assert build.ptxas_report() == {
        "padd_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
                       "Used 168 registers, 380 bytes cmem[0]"
    }
