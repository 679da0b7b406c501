"""The plain reference: the exact affine result of each input set's MSM.

Row r of a set holds (k0 + c_r) * BASE (`inputs.py`), so

    sum_r s_r * P_r = ((k0 * sum_r s_r + sum_r s_r * c_r) mod ORDER) * BASE.

The two sums are read from the same u32 arrays the program is handed:
each scalar as 16 limbs of 16 bits, and for each limb its sum and its sum
weighted by c_r, in int64 on the run's device over `SUM_ROWS` rows at a
time. A limb is below 2^16 and c_r below `MAX_INDEX` = 2^27, so each
chunk's sums stay below 2^16 * 2^27 * 2^20 = 2^63; the chunks add up in
Python ints, exact for any n. Then one scalar multiplication of BASE in
Python ints (`curve.py`).

`control_result` is the same computation with each scalar's low 16 bits
dropped: an MSM at a lower precision, the control that the comparison
has to refuse.
"""
from __future__ import annotations

import numpy as np
import torch

from . import curve
from .inputs import InputSet

SUM_ROWS = 1 << 20  # rows summed in one int64 pass
MAX_INDEX = (1 << 63) // (SUM_ROWS << 16)  # 2^27: a chunk's weighted sum stays below 2^63


def limb_sums(scalars_be: np.ndarray, weights: np.ndarray, device) -> tuple[list[int], list[int]]:
    """For each of the 16 limbs of the [n, 8] BE u32 scalars, lowest first:
    the sum over rows, and the sum weighted by `weights` (each in
    [0, MAX_INDEX)), as Python ints."""
    words = torch.from_numpy(scalars_be.view(np.int32)).to(device)
    index = torch.from_numpy(np.asarray(weights, dtype=np.int64)).to(device)
    if index.numel() and not (0 <= int(index.min()) and int(index.max()) < MAX_INDEX):
        raise ValueError("chain indices must lie in [0, 2^27) for exact int64 sums")
    parts = []
    for lo in range(0, words.shape[0], SUM_ROWS):
        w = words[lo:lo + SUM_ROWS].flip(1).to(torch.int64) & 0xFFFFFFFF  # [m, 8] LE u32
        limbs = torch.stack([w & 0xFFFF, w >> 16], dim=2).reshape(w.shape[0], 16)
        parts.append(torch.stack([limbs.sum(0), (limbs * index[lo:lo + SUM_ROWS, None]).sum(0)]))
    parts = torch.stack(parts).tolist() if parts else []  # [chunks, 2, 16]
    return tuple([sum(p[k][i] for p in parts) for i in range(16)] for k in (0, 1))


def msm_log(k0: int, s: InputSet, device="cpu", drop_low_bits: int = 0) -> int:
    """The result's discrete log to BASE, mod the subgroup order."""
    sums, weighted = limb_sums(s.scalars, s.chain_index, device)
    first = drop_low_bits // 16
    total = sum((k0 * a + b) << (16 * i) for i, (a, b) in enumerate(zip(sums, weighted)) if i >= first)
    return total % curve.SUBGROUP_ORDER


def expected_result(k0: int, s: InputSet, device="cpu") -> tuple[int, int]:
    return curve.times_base(msm_log(k0, s, device))


def control_result(k0: int, s: InputSet, device="cpu") -> tuple[int, int]:
    """The reference at a lower precision: scalars without their low 16 bits."""
    return curve.times_base(msm_log(k0, s, device, drop_low_bits=16))


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
