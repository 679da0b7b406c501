"""Serial host-side Pippenger MSM oracle and the host window combine.

Window split (LSB-first w-bit digits), per-window bucket accumulation,
running-sum bucket reduction and the MSB-first window combine with w
doublings a window. `combine_windows` is the last step of every device
MSM; `msm` and `msm_naive` are the independent serial references the tests
hold the device paths against.
"""
from __future__ import annotations

from typing import Sequence

from . import curve
from .curve import ExtPoint, IDENTITY

SCALAR_BITS = 256


def n_windows(window_size: int) -> int:
    return -(-SCALAR_BITS // window_size)  # ceil(256 / w)


def split_scalar(scalar: int, window_size: int) -> list[int]:
    """LSB-first list of w-bit digits of a 256-bit scalar (the combine
    below walks the list from the top)."""
    mask = (1 << window_size) - 1
    return [
        (scalar >> (k * window_size)) & mask for k in range(n_windows(window_size))
    ]


def bucket_accumulate(
    digits: Sequence[int], points: Sequence[ExtPoint], n_buckets: int
) -> list[ExtPoint]:
    """bucket[b] = sum of points whose digit == b (bucket 0 unused)."""
    buckets = [IDENTITY] * n_buckets
    for digit, point in zip(digits, points):
        if digit == 0:
            continue
        buckets[digit] = curve.add(buckets[digit], point)
    return buckets


def bucket_reduce(buckets: Sequence[ExtPoint]) -> ExtPoint:
    """Running-sum reduction: sum_b b * bucket[b]."""
    total = IDENTITY
    carry = IDENTITY
    for b in range(len(buckets) - 1, 0, -1):
        carry = curve.add(carry, buckets[b])
        total = curve.add(total, carry)
    return total


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
    """Full Pippenger MSM: sum_i scalars[i] * points[i]."""
    assert len(points) == len(scalars)
    k = n_windows(window_size)
    n_buckets = 1 << window_size
    digit_rows = [split_scalar(s, window_size) for s in scalars]
    window_sums = []
    for widx in range(k):
        digits = [row[widx] for row in digit_rows]
        buckets = bucket_accumulate(digits, points, n_buckets)
        window_sums.append(bucket_reduce(buckets))
    return combine_windows(window_sums, window_size)


def msm_naive(points: Sequence[ExtPoint], scalars: Sequence[int]) -> ExtPoint:
    """Direct sum of scalar muls: an independent cross-check of `msm`."""
    acc = IDENTITY
    for p, s in zip(points, scalars):
        acc = curve.add(acc, curve.scalar_mul(p, s))
    return acc
