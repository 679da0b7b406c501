"""Serial host-side Pippenger MSM oracle and the host window combine.

`combine_windows` is the last step of every device MSM; `msm` is the
independent serial reference the tests hold the device path against.
"""
from __future__ import annotations

from typing import Sequence

from . import curve
from .curve import ExtPoint, IDENTITY

SCALAR_BITS = 256


def n_windows(window_size: int) -> int:
    return -(-SCALAR_BITS // window_size)  # ceil(256 / w)


def combine_windows(window_sums: Sequence[ExtPoint], window_size: int) -> ExtPoint:
    """MSB-first fold: result = sum_k 2^(k*w) * W_k.

    `window_sums` is LSB-first (index k covers bits [k*w, (k+1)*w)).
    """
    result = IDENTITY
    for w_sum in reversed(list(window_sums)):
        for _ in range(window_size):
            result = curve.double(result)
        result = curve.add(result, w_sum)
    return result


def msm(
    points: Sequence[ExtPoint], scalars: Sequence[int], window_size: int = 13
) -> ExtPoint:
    """Serial Pippenger: per-window buckets, running-sum reduction, combine."""
    assert len(points) == len(scalars)
    mask = (1 << window_size) - 1
    window_sums = []
    for k in range(n_windows(window_size)):
        buckets = [IDENTITY] * (1 << window_size)
        for s, p in zip(scalars, points):
            digit = (s >> (k * window_size)) & mask
            if digit:
                buckets[digit] = curve.add(buckets[digit], p)
        total = carry = IDENTITY
        for b in range(len(buckets) - 1, 0, -1):
            carry = curve.add(carry, buckets[b])
            total = curve.add(total, carry)
        window_sums.append(total)
    return combine_windows(window_sums, window_size)
