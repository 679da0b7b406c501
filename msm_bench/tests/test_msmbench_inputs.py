"""The input maker and the plain reference against a slow Python-int model.

    python -m pytest msm_bench/tests -q
"""
import hashlib
import random

import numpy as np
import pytest
import torch

from msm_bench.reference import curve, expected, field, inputs



def _ints(rows: np.ndarray, c: int) -> list[int]:
    """Coordinate c of [n, 32] BE u32 rows (or the words of [n, 8] rows, c 0)."""
    return [sum(int(w) << (32 * (7 - j)) for j, w in enumerate(r[8 * c:8 * c + 8])) for r in rows]


def test_field_matches_python_ints():
    rng = random.Random(7)
    a = [rng.randrange(curve.P) for _ in range(40)] + [0, 1, curve.P - 1]
    b = [rng.randrange(curve.P) for _ in range(40)] + [curve.P - 1, 1, curve.P - 1]
    ma, mb = field.to_mont(a, "cpu"), field.to_mont(b, "cpu")
    back = lambda t: field.from_limbs(field.from_mont(t))
    assert back(field.mont_mul(ma, mb)) == [x * y % curve.P for x, y in zip(a, b)]
    assert back(field.add(ma, mb)) == [(x + y) % curve.P for x, y in zip(a, b)]
    assert back(field.sub(ma, mb)) == [(x - y) % curve.P for x, y in zip(a, b)]
    nonzero = [x for x in a if x] * 3  # 126 elements: the tree pads to 128
    assert back(field.batch_inverse(field.to_mont(nonzero, "cpu"))) == [pow(x, -1, curve.P) for x in nonzero]
    wide = [rng.randrange(1 << 256) for _ in range(40)] + [(1 << 256) - 1, 13 * curve.P, 13 * curve.P - 1]
    assert field.from_limbs(field.reduce_256(field.to_limbs(wide, "cpu"))) == [v % curve.P for v in wide]


@pytest.mark.parametrize("host_level", [1, 4, field.HOST_LEVEL])
def test_batch_inverse_at_any_host_level(host_level, monkeypatch):
    monkeypatch.setattr(field, "HOST_LEVEL", host_level)
    values = [random.Random(host_level).randrange(1, curve.P) for _ in range(37)]
    inv = field.from_limbs(field.from_mont(field.batch_inverse(field.to_mont(values, "cpu"))))
    assert inv == [pow(x, -1, curve.P) for x in values]
    with pytest.raises(ZeroDivisionError):
        field.batch_inverse(field.to_mont([3, 0, 5], "cpu"))


@pytest.mark.parametrize("n", [1, 5, 64, 300])
def test_chain_points_are_the_logs_they_claim(n):
    k0 = 123456789 * 10**60 + 17
    rows = inputs.chain_points(k0, n, "cpu")
    xs, ys, ts, zs = (_ints(rows, c) for c in range(4))
    for i in range(n):
        assert (xs[i], ys[i]) == curve.times_base(k0 + i)
        assert ts[i] == xs[i] * ys[i] % curve.P and zs[i] == 1
        assert curve.on_curve(xs[i], ys[i])
    assert len(set(zip(xs, ys))) == n


def test_points_lie_in_the_subgroup():
    rows = inputs.chain_points(99, 4, "cpu")
    for x, y in zip(_ints(rows, 0), _ints(rows, 1)):
        assert curve.affine(curve.scalar_mul(curve.ext(x, y), curve.SUBGROUP_ORDER)) == (0, 1)


def test_input_sets():
    made = inputs.make_inputs(2**31 + 5, [96], 4, False, 253, "cpu")
    again = inputs.make_inputs(2**31 + 5, [96], 4, False, 253, "cpu")
    other = inputs.make_inputs(2**31 + 6, [96], 4, False, 253, "cpu")
    assert made.k0 == again.k0 and made.k0 != other.k0
    for s, t in zip(made.sets, again.sets):
        assert np.array_equal(s.points, t.points) and np.array_equal(s.scalars, t.scalars)
    orders = {tuple(s.chain_index) for s in made.sets}
    assert len(orders) == 4 and all(sorted(o) == list(range(96)) for o in orders)
    assert len({s.scalars.tobytes() for s in made.sets}) == 4
    for s in made.sets:
        assert s.points.dtype == np.uint32 and s.points.shape == (96, 32)
        assert s.scalars.dtype == np.uint32 and s.scalars.shape == (96, 8)
        assert max(_ints(s.scalars, 0)) < curve.P
        assert expected.points_on_chain(made.k0, s, range(0, 96, 7)) == 0
    fixed = inputs.make_inputs(3, [64], 3, True, 253, "cpu")
    assert all(s.points is fixed.sets[0].points for s in fixed.sets)
    assert len({s.scalars.tobytes() for s in fixed.sets}) == 3


def test_scalar_bits():
    s = inputs.make_inputs(1, [200], 1, False, 64, "cpu").sets[0]
    vals = _ints(s.scalars, 0)
    assert max(vals) < 1 << 64 and max(vals) > 1 << 60


def test_expected_result_is_the_msm():
    made = inputs.make_inputs(77, [48, 32], 2, False, 253, "cpu")
    for s in made.sets:
        xs, ys, ks = _ints(s.points, 0), _ints(s.points, 1), _ints(s.scalars, 0)
        acc = curve.IDENTITY
        for x, y, k in zip(xs, ys, ks):
            acc = curve.add(acc, curve.scalar_mul(curve.ext(x, y), k))
        assert expected.expected_result(made.k0, s) == curve.affine(acc)
        assert expected.control_result(made.k0, s) != curve.affine(acc)


def test_points_on_chain_sees_a_wrong_row():
    made = inputs.make_inputs(8, [16], 1, False, 253, "cpu")
    s = made.sets[0]
    s.points[3, 7] ^= 1
    assert expected.points_on_chain(made.k0, s, range(16)) == 1


def _digest(made) -> str:
    h = hashlib.sha256(made.k0.to_bytes(32, "big"))
    for s in made.sets:
        for a in (s.points, s.scalars, s.chain_index):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:32]


# (seed, sizes, sets, fixed bases, scalar bits) shaped like the traffic
# files, and the digest of make_inputs' output as the one-chunk maker
# gave it: chunking changed no byte and no draw.
DIGESTS = [
    ((2**31 + 5, [96], 4, False, 253), "0d9642725fcce5bdb2af537d348fe306"),
    ((3, [64], 3, True, 253), "d755bca8ed6903fbb3291c83d55cf67d"),
    ((2**40 + 7, [128], 8, True, 253), "568c4bf71bd898579de85b42fd0fbfde"),
    ((77, [48, 32], 2, False, 253), "012c50fa362ef7445d7f178421e57977"),
    ((1, [200], 2, False, 64), "19174703c091304065b8b096fa7cbe6d"),
    ((2**33 + 1, [300], 2, False, 253), "51e63159c344f85871a21d6b71395711"),
]


@pytest.mark.parametrize("args, digest", DIGESTS)
def test_inputs_are_the_one_chunk_makers(args, digest):
    assert _digest(inputs.make_inputs(*args, "cpu")) == digest


@pytest.mark.parametrize("fixed", [True, False])
def test_chunked_rows_equal_one_chunk_rows(fixed, monkeypatch):
    whole = inputs.make_inputs(2**35 + 3, [300], 2, fixed, 253, "cpu")
    monkeypatch.setattr(inputs, "CHUNK_ROWS", 37)
    chunked = inputs.make_inputs(2**35 + 3, [300], 2, fixed, 253, "cpu")
    assert chunked.k0 == whole.k0
    for s, t in zip(chunked.sets, whole.sets):
        assert np.array_equal(s.points, t.points) and np.array_equal(s.chain_index, t.chain_index)
        assert np.array_equal(s.scalars, t.scalars)


def test_scalars_in_slices(monkeypatch):
    """Drawn 50 at a time; the same scalars whatever the group reduced at once."""
    monkeypatch.setattr(inputs, "SCALAR_SLICE", 50)
    made = []
    for group in (50, 100, 1 << 23):
        monkeypatch.setattr(inputs, "SCALAR_GROUP", group)
        made.append(inputs.make_inputs(9, [120], 1, True, 253, "cpu").sets[0].scalars)
    assert all(np.array_equal(m, made[0]) for m in made)
    assert made[0].shape == (120, 8) and made[0].flags.c_contiguous
    vals = _ints(made[0], 0)
    assert max(vals) < curve.P and len(set(vals)) == 120


def test_chain_refuses_past_2p26():
    with pytest.raises(ValueError):
        inputs.make_inputs(1, [(1 << 26) + 1], 1, True, 253, "cpu")


@pytest.mark.parametrize("n, ones", [(300, False), ((1 << 22) + 5, True)])
def test_msm_log_is_exact_at_the_largest_chain_indices(n, ones):
    """Chain indices up to 2^26 - 1; at 2^22 rows of all-ones scalars a
    limb's weighted sum over the set passes 2^64, one chunk's stays in
    int64."""
    rng = np.random.default_rng(n)
    index = rng.integers((1 << 26) - (1 << 20), 1 << 26, n)
    index[0] = (1 << 26) - 1
    k0 = curve.SUBGROUP_ORDER - (1 << 26) - 2
    if ones:
        scalars = np.full((n, 8), 0xFFFFFFFF, dtype=np.uint32)
        want = ((1 << 256) - 1) * (n * k0 + int(index.sum()))
    else:
        scalars = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint32)
        want = sum(k * (k0 + int(c)) for k, c in zip(_ints(scalars, 0), index))
    s = inputs.InputSet(points=None, scalars=scalars, chain_index=index)
    assert expected.msm_log(k0, s) == want % curve.SUBGROUP_ORDER


def test_msm_log_refuses_indices_past_its_bound():
    s = inputs.InputSet(points=None, scalars=np.ones((2, 8), np.uint32),
                        chain_index=np.array([0, expected.MAX_INDEX]))
    with pytest.raises(ValueError):
        expected.msm_log(5, s)


def test_chunked_limb_sums_equal_one_shot(monkeypatch):
    rng = np.random.default_rng(4)
    scalars = rng.integers(0, 1 << 32, (100, 8), dtype=np.uint32)
    index = rng.integers(0, 1 << 26, 100)
    ks = _ints(scalars, 0)
    limb = lambda k, i: (k >> (16 * i)) & 0xFFFF
    one_shot = ([sum(limb(k, i) for k in ks) for i in range(16)],
                [sum(limb(k, i) * int(c) for k, c in zip(ks, index)) for i in range(16)])
    assert expected.limb_sums(scalars, index, "cpu") == one_shot
    monkeypatch.setattr(expected, "SUM_ROWS", 7)
    assert expected.limb_sums(scalars, index, "cpu") == one_shot


def test_host_buffers_raise_what_their_thread_met(monkeypatch):
    def fail(self):
        raise RuntimeError("cannot map the pages")

    monkeypatch.setattr(torch.Tensor, "zero_", fail)
    buffers = inputs._HostBuffers([(4, 4), (2, 2)])
    with pytest.raises(RuntimeError, match="cannot map"):
        buffers.take(1)
    buffers.close()
    assert not buffers._thread.is_alive()
