"""The plain reference: the exact affine result of each input set's MSM.

Row r of a set holds (k0 + c_r) * BASE (`inputs.py`), so

    sum_r s_r * P_r = ((k0 * sum_r s_r + sum_r s_r * c_r) mod ORDER) * BASE.

The two sums are read from the same u32 arrays the program is handed, in
numpy: each scalar as 16 limbs of 16 bits, limb sums over n < 2^21 rows
(below 2^37 for sum s_r, 2^57 for sum s_r c_r with c_r < 2^21), then
one scalar multiplication of BASE in Python ints (`curve.py`).

`control_result` is the same computation with each scalar's low 16 bits
dropped: an MSM at a lower precision, the control that the comparison
has to refuse.
"""
from __future__ import annotations

import numpy as np

from . import curve
from .inputs import InputSet


def _limb_sums(scalars_be: np.ndarray, weights: np.ndarray) -> tuple[list[int], list[int]]:
    words = scalars_be.astype(np.uint64)[:, ::-1]  # [n, 8] LE u32
    limbs = np.empty((words.shape[0], 16), dtype=np.uint64)
    limbs[:, 0::2] = words & 0xFFFF
    limbs[:, 1::2] = words >> np.uint64(16)
    return ([int(v) for v in limbs.sum(axis=0)],
            [int(v) for v in (limbs * weights.astype(np.uint64)[:, None]).sum(axis=0)])


def msm_log(k0: int, s: InputSet, drop_low_bits: int = 0) -> int:
    """The result's discrete log to BASE, mod the subgroup order."""
    assert s.chain_index.max(initial=0) < (1 << 21), "sum s_r c_r would leave uint64"
    sums, weighted = _limb_sums(s.scalars, s.chain_index)
    first = drop_low_bits // 16
    total = sum((k0 * a + b) << (16 * i) for i, (a, b) in enumerate(zip(sums, weighted)) if i >= first)
    return total % curve.SUBGROUP_ORDER


def expected_result(k0: int, s: InputSet) -> tuple[int, int]:
    return curve.times_base(msm_log(k0, s))


def control_result(k0: int, s: InputSet) -> tuple[int, int]:
    """The reference at a lower precision: scalars without their low 16 bits."""
    return curve.times_base(msm_log(k0, s, drop_low_bits=16))


def points_on_chain(k0: int, s: InputSet, rows: np.ndarray) -> int:
    """How many of the given rows of s are not (k0 + c_r) * BASE with z = 1
    and t = x * y: the inputs' own check, in Python ints."""
    bad = 0
    for r in rows:
        words = [int(w) for w in s.points[r]]
        x, y, t, z = (sum(w << (32 * (7 - j)) for j, w in enumerate(words[8 * c:8 * c + 8]))
                      for c in range(4))
        if (x, y) != curve.times_base(k0 + int(s.chain_index[r])) or z != 1 or t != x * y % curve.P:
            bad += 1
    return bad
