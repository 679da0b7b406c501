"""The input maker and the plain reference against a slow Python-int model.

    python -m pytest msm_bench/tests -q
"""
import random

import numpy as np
import pytest

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


def test_batch_inverse_refuses_zero():
    with pytest.raises(ZeroDivisionError):
        field.batch_inverse(field.to_mont([3, 0, 5], "cpu"))


@pytest.mark.parametrize("n", [1, 5, 64, 300])
def test_chain_points_are_the_logs_they_claim(n):
    k0 = 123456789 * 10**60 + 17
    rows = inputs._u32(inputs.chain_points(k0, n, "cpu"))
    xs, ys, ts, zs = (_ints(rows, c) for c in range(4))
    for i in range(n):
        assert (xs[i], ys[i]) == curve.times_base(k0 + i)
        assert ts[i] == xs[i] * ys[i] % curve.P and zs[i] == 1
        assert curve.on_curve(xs[i], ys[i])
    assert len(set(zip(xs, ys))) == n


def test_points_lie_in_the_subgroup():
    rows = inputs._u32(inputs.chain_points(99, 4, "cpu"))
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
