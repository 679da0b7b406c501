"""`reduce_finish` of the port on the CPU: its plain version, which adds in
the order of the cluster kernel (`_fold_sums`), against the JAX package's
`reduce_buckets` and against the oracle, as affine points (the order of
the adds picks the digits), and the kernel's plan of threads.

The JAX function runs op by op under `jax.disable_jit()`, once for the
file (about 20 s): its window sums do not depend on the group size, so one
call at groups of 4 holds the port at every Gs. The kernel's own digits are
held to the plain version on the card (tests/test_torch_gpu.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.ops import pippenger as jpip
from webgpu_msm_tpu.oracle import curve as joc
from webgpu_msm_tpu.oracle import field as F
from webgpu_msm_tpu.utils import fixtures as jfixtures

from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle import curve as oc
from webgpu_msm_tpu_torch.utils import fixtures
from webgpu_msm_tpu_torch.utils.interop import (affine_from_planes, mont_planes_from_points, planes_from_numpy,
                                               planes_to_numpy)

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

K, B = 2, 32


def _jax_planes(points) -> np.ndarray:
    """JAX ExtPoints -> [4, 16, n] uint32 Montgomery digit planes."""
    out = np.zeros((4, 16, len(points)), dtype=np.uint32)
    for i, p in enumerate(points):
        for c, v in enumerate((p.x, p.y, p.t, p.z)):
            m = F.to_mont(v)
            out[c, :, i] = [(m >> (16 * d)) & 0xFFFF for d in range(16)]
    return out


def _affine_mont(st) -> list:
    return affine_from_planes(planes_to_numpy(st))


@pytest.fixture(scope="module")
def jax_case():
    """Bucket sums [4, 16, K, B] (two of them the identity) and the JAX
    package's window sums of them, from its grouped CPU fallback at Gs 4."""
    pts = jfixtures.distinct_points_fast(K * B, seed=97)
    pts[5], pts[B + 17] = joc.IDENTITY, joc.IDENTITY
    bs = _jax_planes(pts).reshape(4, 16, K, B)
    with jax.disable_jit():
        want = np.asarray(jpip.reduce_buckets(jnp.asarray(bs), group_size=4))
    return bs, _affine_mont(planes_from_numpy(want))


@pytest.mark.parametrize("Gs", [2, 4, 8, 16, 32])
def test_plain_order_matches_jax_reduce_buckets(jax_case, Gs):
    """The first grouped pass, then `reduce_finish_plain` over G = B / Gs
    groups with log2(Gs) doublings: the JAX window sums as affine points,
    in both output domains."""
    bs, want = jax_case
    G = B // Gs
    s = planes_from_numpy(bs).reshape(4, 16, K * G, Gs).permute(3, 0, 1, 2).contiguous()
    T, U = pk.grouped_running_sum_plain(s)
    plain, mont = pk.reduce_finish_plain(T, U, K, Gs.bit_length() - 1)
    assert plain.dtype == mont.dtype == torch.int32 and plain.shape == mont.shape == (4, 16, K)
    assert _affine_mont(mont) == want
    assert affine_from_planes(planes_to_numpy(plain), mont=False) == want


def _window_sums(T_pts, U_pts, n_windows, doublings) -> list:
    """The oracle's 2^d * sum_g g * T_g + sum_g U_g of each window, affine:
    sum_g g * T_g by the serial running sum from the top group down."""
    G = len(T_pts) // n_windows
    out = []
    for k in range(n_windows):
        run = acc = tot = oc.IDENTITY
        for g in range(G - 1, -1, -1):
            run = oc.add(run, T_pts[k * G + g])
            if g:
                acc = oc.add(acc, run)
            tot = oc.add(tot, U_pts[k * G + g])
        for _ in range(doublings):
            acc = oc.double(acc)
        out.append(oc.to_affine(oc.add(acc, tot)))
    return out


@pytest.mark.parametrize("K_,G,doublings", [
    (1, 1, 3), (1, 2, 0), (1, 31, 5), (1, 129, 4), (1, 683, 1), (1, 1025, 5),  # one window
    (20, 1, 2), (20, 2, 5), (20, 31, 0),  # the wire call's 20 windows at small G
])
def test_plain_order_matches_the_oracle(K_, G, doublings):
    """Random points as T and U: the window sums equal the oracle's as
    affine points; the plain output is the Montgomery output's from_mont.
    G 1 (no weighted sum), powers of two (no group beyond the walk's
    first), G 129 (one lane walks two groups), 683 and 1 025 (every lane
    walks two or more)."""
    pts = fixtures.distinct_points_fast(2 * K_ * G, seed=G + doublings)
    T = planes_from_numpy(mont_planes_from_points(pts[: K_ * G]))
    U = planes_from_numpy(mont_planes_from_points(pts[K_ * G :]))
    plain, mont = pk.reduce_finish_plain(T, U, K_, doublings)
    want = _window_sums(pts[: K_ * G], pts[K_ * G :], K_, doublings)
    assert _affine_mont(mont) == want
    assert affine_from_planes(planes_to_numpy(plain), mont=False) == want


@pytest.mark.parametrize("G", [1, 2, 129, 1025])
def test_plain_order_on_identity_inputs(G):
    """All-identity T and U give the identity; all-identity T with random
    U gives sum_g U_g (every add of an identity digit form included)."""
    ident = planes_from_numpy(mont_planes_from_points([oc.IDENTITY] * G))
    plain, mont = pk.reduce_finish_plain(ident, ident, 1, 5)
    assert _affine_mont(mont) == [oc.to_affine(oc.IDENTITY)]
    assert affine_from_planes(planes_to_numpy(plain), mont=False) == [oc.to_affine(oc.IDENTITY)]
    pts = fixtures.distinct_points_fast(G, seed=3)
    _, mont = pk.reduce_finish_plain(ident, planes_from_numpy(mont_planes_from_points(pts)), 1, 5)
    assert _affine_mont(mont) == _window_sums([oc.IDENTITY] * G, pts, 1, 5)


@pytest.mark.parametrize("G,plan", [
    (1, (1, 1)), (2, (1, 2)), (31, (1, 16)), (32, (1, 32)), (64, (2, 32)),
    (129, (4, 32)),     # the wire call: 128 lanes on 4 SMs a window
    (683, (8, 32)),
    (1025, (8, 32)),    # the resident call: 256 lanes on a cluster of 8, 4 or 5 groups a lane
    (8200, (8, 32)),    # Gs 4 over the resident buckets: 32 or 33 groups a lane
])
def test_finish_plan(G, plan):
    """(M blocks a window, NL lanes a block): M * NL the largest power of
    two at most G and 256, 32 lanes a block where that allows."""
    M, NL = pk._finish_plan(G)
    assert (M, NL) == plan
    assert M <= pk.FINISH_CLUSTER and NL <= pk.FINISH_LANES
    assert M * NL == min(1 << (G.bit_length() - 1), pk.FINISH_CLUSTER * pk.FINISH_LANES)


def test_wrapper_on_cpu_tensors_runs_the_plain_version_uncounted():
    pts = fixtures.distinct_points_fast(2 * 3 * 5, seed=7)
    T = planes_from_numpy(mont_planes_from_points(pts[:15]))
    U = planes_from_numpy(mont_planes_from_points(pts[15:]))
    pk.reset_launch_counts()
    got = pk.reduce_finish(T, U, 3, 2)
    for g, w in zip(got, pk.reduce_finish_plain(T, U, 3, 2)):
        assert torch.equal(g, w) and g.dtype == torch.int32
    assert pk.launches == {name: 0 for name in pk.KERNELS}
