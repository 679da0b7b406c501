"""The matrix-form Montgomery reduction of the port (the plain version of
the tensor-core scan kernels) against the JAX package's MXU form, and the
gathering scan on that product against the CIOS one and the JAX batch
stage.

`kmont_mul_mxu` is plain jnp over digit lists and needs no Pallas, so it
runs directly on the CPU; the JAX batch stage runs op by op under
`jax.disable_jit()`. Every comparison is exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_tpu.ops import pippenger as jpip
from webgpu_msm_tpu.ops.pallas import field_kernels_mxu as jmxu
from webgpu_msm_tpu.oracle import field as F
from webgpu_msm_tpu.utils import convert, fixtures

from webgpu_msm_tpu_torch.ops import field_ops, limbs, pippenger
from webgpu_msm_tpu_torch.ops.kernels import field_kernels_mma as fm
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.oracle import field as tF
from webgpu_msm_tpu_torch.utils.interop import planes_from_numpy, planes_to_numpy

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

N = 24


def rand_elems(rng, n):
    """n field elements with the edge values 0, 1, p-1."""
    return [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(n - 3)] + [0, 1, F.P - 1]


def to_planes(vals) -> np.ndarray:
    return np.array([[(v >> (16 * k)) & 0xFFFF for v in vals] for k in range(16)], np.uint32)


def from_planes(arr) -> list[int]:
    arr = np.asarray(arr, dtype=np.uint64)
    return [sum(int(arr[k, i]) << (16 * k) for k in range(16)) for i in range(arr.shape[1])]


def port(a: np.ndarray) -> torch.Tensor:
    return limbs.as_i64(planes_from_numpy(a))


def test_n0_inv_256_matches_jax():
    assert tF.N0_INV_256 == F.N0_INV_256
    assert (tF.N0_INV_256 * F.P + 1) % (1 << 256) == 0


def test_m2_matrix_matches_jax():
    m2 = fm.m2_matrix()
    assert m2.dtype == np.uint8 and m2.shape == (64, 32)
    np.testing.assert_array_equal(m2.astype(np.float32), jmxu._m2_matrix())


def test_m1_matrix_matches_jax_where_the_forms_coincide():
    """The JAX M1 takes three byte planes per lazy 16-bit column: its
    column 3k+j stands at byte 2k+j, where the port's column 2k+j stands."""
    m1, jm1 = fm.m1_matrix(), jmxu._m1_matrix()
    assert m1.dtype == np.uint8 and m1.shape == (32, 32) and jm1.shape == (32, 48)
    for k in range(16):
        for j in range(3):
            if 2 * k + j < 32:
                np.testing.assert_array_equal(m1[:, 2 * k + j].astype(np.float32), jm1[:, 3 * k + j])


def rand_planes(rng, lead, width):
    """Random field elements below p as [*lead, 16, width] uint32 digits."""
    d = rng.integers(0, 1 << 16, size=lead + (16, width), dtype=np.uint32)
    d[..., 15, :] %= 0x12AB  # p's top digit is 0x12ab
    return d


@pytest.mark.parametrize("which", ["m1", "m2"])
def test_matrices_multiply_by_their_constants(which):
    """Folded with their byte weights, M1's columns give x * N0' mod 2^256
    and M2's give x * p, for 32-byte x."""
    rng = np.random.default_rng(3)
    xs = [int.from_bytes(rng.bytes(32), "little") for _ in range(8)] + [0, (1 << 256) - 1]
    mat = (fm.m1_matrix() if which == "m1" else fm.m2_matrix()).astype(np.int64)
    for x in xs:
        xb = np.array([(x >> (8 * k)) & 0xFF for k in range(32)], dtype=np.int64)
        cols = mat @ xb
        assert int(cols.max()) < 1 << 21  # s32 (and float32) sums are exact
        got = sum(int(c) << (8 * o) for o, c in enumerate(cols))
        if which == "m1":
            assert got % (1 << 256) == x * F.N0_INV_256 % (1 << 256)
        else:
            assert got == x * F.P


def test_const_inputs_are_the_kernel_arguments():
    m1, m2 = fm.const_inputs("cpu")
    assert m1.dtype == m2.dtype == torch.uint8
    assert tuple(m1.shape) == (32, 32) and tuple(m2.shape) == (64, 32)
    assert m1.is_contiguous() and m2.is_contiguous()
    np.testing.assert_array_equal(m1.numpy(), fm.m1_matrix())
    np.testing.assert_array_equal(m2.numpy(), fm.m2_matrix())


def test_mont_mul_mma_plain_matches_jax_mxu_and_cios():
    rng = np.random.default_rng(11)
    a, b = to_planes(rand_elems(rng, N)), to_planes(rand_elems(rng, N)[::-1])
    got = planes_to_numpy(fm.mont_mul_mma_plain(port(a), port(b)))
    m1, m2 = (jnp.asarray(m) for m in jmxu.const_inputs())
    want = jmxu.kmont_mul_mxu([jnp.asarray(a[k]) for k in range(16)],
                              [jnp.asarray(b[k]) for k in range(16)], m1, m2)
    np.testing.assert_array_equal(got, np.asarray(jnp.stack(want)))
    np.testing.assert_array_equal(got, planes_to_numpy(field_ops.mont_mul(port(a), port(b))))
    rinv = pow(F.R, -1, F.P)
    assert from_planes(got) == [x * y * rinv % F.P for x, y in zip(from_planes(a), from_planes(b))]


def test_mont_mul_mma_plain_broadcasts_a_constant():
    rng = np.random.default_rng(12)
    a = port(to_planes(rand_elems(rng, N)))
    c = limbs.const_planes(F.R2_MOD_P, 1, "cpu")
    assert torch.equal(fm.mont_mul_mma_plain(a, c), field_ops.mont_mul(a, c))


S = 1 << 31  # sign flag
PATTERNS = [
    [5] * 8, [3] * 4 + [7] * 4, list(range(8)),
    [9, 9 | S, 9, 9 | S, 9, 9, 9 | S, 9], [4 | S, 4, 2 | S, 2 | S, 2, 8, 8 | S, 1],
]


def scan_inputs(seed):
    L, W = 8, len(PATTERNS)
    rng = np.random.default_rng(seed)
    niels = rng.integers(0, 1 << 16, size=(3, 16, L, W), dtype=np.uint32)
    niels[:, 15] %= 0x12AB  # below p
    packed = niels[:, 0::2] | (niels[:, 1::2] << 16)
    ids = np.array(PATTERNS, dtype=np.uint32).T.copy()
    return planes_from_numpy(packed), planes_from_numpy(ids)


def test_scan_plain_with_mma_equals_scan_plain():
    pts, ids = scan_inputs(13)
    want = pk.accumulate_scan_plain(pts, ids)
    got = pk.accumulate_scan_plain(pts, ids, use_mma=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_wrapper_with_use_mma_runs_the_plain_version_on_the_cpu():
    pts, ids = scan_inputs(14)
    pk.reset_launch_counts()
    got = pk.accumulate_scan(pts, ids, use_mma=True)
    assert pk.launches == {name: 0 for name in pk.KERNELS}
    for g, w in zip(got, pk.accumulate_scan(pts, ids)):
        assert torch.equal(g, w)


def gather_inputs(rng, sorted_ids: np.ndarray, C: int, L: int):
    """The gathering scan's arguments for K windows of C lanes of L steps:
    rows [C * L, 24] of random Niels limbs below p, and perm and ids [L,
    K * C] from each window's sorted ids (with random signs) over a random
    order of the points."""
    K, M = sorted_ids.shape
    niels = rand_planes(rng, (3,), M)
    rows = (niels[:, 0::2] | (niels[:, 1::2] << 16)).reshape(24, M).T.copy()
    perm = np.stack([rng.permutation(M) for _ in range(K)]).astype(np.uint32)
    ids = sorted_ids.astype(np.uint32) | (rng.integers(0, 2, size=(K, M)).astype(np.uint32) << 31)
    lanes = lambda a: planes_from_numpy(a.reshape(K, C, L).transpose(2, 0, 1).reshape(L, K * C).copy())
    return planes_from_numpy(rows), lanes(perm), lanes(ids)


def runs(*spec) -> list[int]:
    """Sorted ids from (bucket, run length) pairs."""
    return [b for b, n in spec for _ in range(n)]


# One window of C 8 lanes of L 8 steps (W 8), over B 16 buckets: runs over
# two and three lanes, runs ending exactly at a lane edge (positions 16 and
# 40), single points, and the top bucket.
ONE_WINDOW = [runs((0, 3), (2, 13), (5, 8), (6, 1), (9, 15), (11, 8), (12, 1), (15, 15))]


@pytest.mark.parametrize("windows", ["patterns", "two windows"])
def test_gather_scan_plain_with_mma_equals_gather_scan_plain(windows):
    """The gathering scan on the matrix-form product equals it on CIOS
    products, every output digit: one window of hand-made runs (W 8), or
    a two-window split of random ids over few buckets (W 16)."""
    rng = np.random.default_rng(15)
    C, L = 8, 8
    if windows == "patterns":
        sorted_ids, B = np.array(ONE_WINDOW), 16
    else:
        sorted_ids, B = np.sort(rng.integers(0, 6, size=(2, C * L)), axis=1), 6
    args = gather_inputs(rng, sorted_ids, C, L) + (sorted_ids.shape[0], B)
    want = pk.accumulate_scan_gather_plain(*args)
    got = pk.accumulate_scan_gather_plain(*args, use_mma=True)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the ids cross lane edges: some partial sum is not the identity
    assert not torch.equal(want[2], pk.identity_planes((want[2].shape[-1],), "cpu"))


def test_gather_wrapper_with_use_mma_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(16)
    args = gather_inputs(rng, np.array(ONE_WINDOW), 8, 8) + (1, 16)
    pk.reset_launch_counts()
    got = pk.accumulate_scan_gather(*args, use_mma=True)
    assert pk.launches == {name: 0 for name in pk.KERNELS}
    for g, w in zip(got, pk.accumulate_scan_gather_plain(*args)):
        assert torch.equal(g, w)


def test_batch_stage_on_the_mma_gather_scan_matches_jax(monkeypatch):
    """The port's `_accumulate_batch` (the digits' sort and lanes, then the
    gathering scan, `lane_scan`, `assemble_buckets`) with the scan on the
    matrix-form product gives the JAX `_accumulate_batch`'s bucket sums,
    digit for digit: w 8 signed (K 32, B 160), C 2 x L 8. Ten of the 16
    scalars are equal, so in every window one run spans both lanes."""
    w, C, L = 8, 2, 8
    M, K, B = C * L, -(-256 // w), pippenger.n_buckets(w, True)
    sc = fixtures.random_scalars(M, seed=81)
    sc[:10] = [sc[0]] * 10
    sc[10:12] = [0, F.P - 1]
    words = convert.bigints_to_u32_be(sc)[:, ::-1].T.copy()  # [8, M] LE words
    niels = rand_planes(np.random.default_rng(82), (3,), M)
    with jax.disable_jit():
        want = jpip._accumulate_batch(jnp.asarray(niels),
                                      jpip.compute_digits(jnp.asarray(words), w, True), w, C, L, B)
    digits = pippenger.compute_digits(limbs.as_i64(planes_from_numpy(words)), w, True)
    products = []
    real_mul = fm.mont_mul_mma_plain
    monkeypatch.setattr(fm, "mont_mul_mma_plain", lambda a, b: products.append(1) or real_mul(a, b))
    monkeypatch.setattr(pk, "accumulate_scan_gather",
                        functools.partial(pk.accumulate_scan_gather, use_mma=True))
    pk.reset_launch_counts()
    got = pippenger._accumulate_batch(pk.pack_rows(planes_from_numpy(niels)), digits, w, C, L, B)
    assert len(products) == 7 * L and pk.launches  # the Niels add's 7 products a step == {name: 0 for name in pk.KERNELS}
    np.testing.assert_array_equal(planes_to_numpy(got), np.asarray(want))
