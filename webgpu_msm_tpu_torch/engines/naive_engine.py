"""Naive MSM: a double-and-add ladder for every point, then a tree sum.

The counterpart of the JAX package's `engines/naive_engine.py`, the
reference's naive baseline row: every point gets a full 256-step ladder
(MSB first: `double`, `add_mixed`, `select`), and the n products are
summed by `pippenger._tree_sum_axis`. About 25x the field products of
Pippenger, kept as the lower-bound comparison row. The ladder is plain
PyTorch on `device` (XLA outside any Pallas kernel in the JAX package); the
tree sum launches the `padd_masked` kernel once a level on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..config import MSMConfig
from ..oracle import curve as ocurve
from ..oracle.curve import ExtPoint
from ..ops import curve_ops, field_ops, limbs, pippenger
from . import gpu_engine

# The whole 256-bit scalar: the API takes any u256 scalar, and the other
# engines reduce them with full 256-bit windows.
SCALAR_BITS = 256


def _device_naive(points_plain: torch.Tensor, scalar_words: torch.Tensor) -> torch.Tensor:
    """[3, 16, n] plain affine (x, y, t) and [8, n] LE scalar words (int32
    bits) -> [4, 16] int64 plain extended sum."""
    n = points_plain.shape[-1]
    x, y, t = (field_ops.to_mont(limbs.as_i64(points_plain[i])) for i in range(3))
    words = limbs.as_i64(scalar_words)
    acc = curve_ops.identity((n,), points_plain.device)
    for i in range(SCALAR_BITS):
        bit = SCALAR_BITS - 1 - i
        on = ((words[bit // 32] >> (bit % 32)) & 1) == 1
        acc = curve_ops.double(acc)
        acc = curve_ops.select(on, curve_ops.add_mixed(acc, x, y, t), acc)
    total = pippenger._tree_sum_axis(acc.stacked().reshape(4, 16, 1, n))[..., 0]
    return torch.stack([field_ops.from_mont(total[i]) for i in range(4)])


def msm_affine(points: Sequence[ExtPoint], scalars: Sequence[int], config: MSMConfig,
               device: torch.device) -> tuple[int, int]:
    n = len(points)
    pad_to = max(-(-n // 128) * 128, 128)
    pts = gpu_engine._host_tensor(gpu_engine.marshal_points(points, pad_to), device)
    sc = gpu_engine._host_tensor(gpu_engine.marshal_scalars(scalars, pad_to), device)
    out = _device_naive(pts.to(device, non_blocking=True), sc.to(device, non_blocking=True))
    p = gpu_engine.window_sums_to_points(out.cpu().numpy()[:, :, None])[0]
    return ocurve.to_affine(p)
