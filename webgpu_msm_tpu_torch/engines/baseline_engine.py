"""The Demox-Labs baseline: the reference's `webgpu_pippenger_msm` row.

The counterpart of the JAX package's `engines/baseline_engine.py`, the
comparator the reference had to beat by 10 %, so its shape is kept rather
than made fast: a fixed window of c = 16 bits, bucketing on the host (the
baseline adds a bucket's points in host bigint arithmetic), the device
doing only the bucket-value x bucket-index products (a vectorized 16-step
ladder, plain PyTorch on `device`, in chunks of `_LADDER_CHUNK`), and the
window sums and the window combine on the host.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import MSMConfig
from ..oracle import curve as ocurve
from ..oracle.curve import ExtPoint
from ..ops import curve_ops, field_ops, limbs
from ..utils import convert
from . import gpu_engine

C_BITS = 16  # the baseline's fixed window
N_WINDOWS = 256 // C_BITS
# Width of one ladder call: bucket entries stream through in chunks, so
# device memory follows the chunk, not the input.
_LADDER_CHUNK = 1 << 17


def _device_mul_16bit(points_plain: torch.Tensor, small_scalars: torch.Tensor) -> torch.Tensor:
    """[3, 16, m] plain affine (x, y, t) and [m] scalars below 2^16 (int32)
    -> [4, 16, m] int64 plain extended products."""
    x, y, t = (field_ops.to_mont(limbs.as_i64(points_plain[i])) for i in range(3))
    k = limbs.as_i64(small_scalars)
    acc = curve_ops.identity((points_plain.shape[-1],), points_plain.device)
    for j in range(C_BITS):
        acc = curve_ops.double(acc)
        bit = (k >> (C_BITS - 1 - j)) & 1
        acc = curve_ops.select(bit == 1, curve_ops.add_mixed(acc, x, y, t), acc)
    return torch.stack([field_ops.from_mont(c) for c in acc])


def _host_bucket_entries(points: Sequence[ExtPoint],
                         scalars: Sequence[int]) -> list[tuple[int, int, ExtPoint]]:
    """Host bucketing: (window, digit, sum of the bucket's points) for every
    non-empty bucket of every window. The grouping is a numpy digit split
    and a stable argsort; the adds are host `ocurve.add` chains, one a
    colliding point, as many as the baseline's map performs."""
    words = convert.bigints_to_words_le([int(s) % (1 << 256) for s in scalars])  # [8, n] LE
    entries: list[tuple[int, int, ExtPoint]] = []
    for w in range(N_WINDOWS):
        # C_BITS = 16: two digits a u32 word
        digits = (words[w // 2] >> np.uint32(16 * (w % 2))) & np.uint32(0xFFFF)
        order = np.argsort(digits, kind="stable")
        ds = digits[order]
        starts = np.flatnonzero(np.r_[True, ds[1:] != ds[:-1]])
        ends = np.r_[starts[1:], len(ds)]
        for s0, e0 in zip(starts.tolist(), ends.tolist()):
            d = int(ds[s0])
            if d == 0:
                continue
            acc = points[order[s0]]
            for i in range(s0 + 1, e0):
                acc = ocurve.add(acc, points[order[i]])
            entries.append((w, d, acc))
    return entries


def _combine(entries: Sequence[tuple[int, int, ExtPoint]],
             products: Sequence[ExtPoint]) -> tuple[int, int]:
    """Host: each window's sum of its products, then the window combine
    with 2^16 scaling between windows."""
    window_sums = [ocurve.IDENTITY] * N_WINDOWS
    for (w, _d, _p), prod in zip(entries, products):
        window_sums[w] = ocurve.add(window_sums[w], prod)
    acc = ocurve.IDENTITY
    for w in reversed(range(N_WINDOWS)):
        acc = ocurve.scalar_mul(acc, 1 << C_BITS)
        acc = ocurve.add(acc, window_sums[w])
    return ocurve.to_affine(acc)


def _device_products(entries: Sequence[tuple[int, int, ExtPoint]],
                     device: torch.device) -> list[ExtPoint]:
    """Every entry's point times its digit on `device`; every chunk is
    queued before any is fetched."""
    m = len(entries)
    chunk = min(_LADDER_CHUNK, max(-(-m // 128) * 128, 128))
    pad_to = -(-m // chunk) * chunk
    pts = gpu_engine.marshal_points([e[2] for e in entries], pad_to)
    idx = np.zeros(pad_to, dtype=np.uint32)
    idx[:m] = [e[1] for e in entries]
    outs = [
        _device_mul_16bit(
            gpu_engine._host_tensor(pts[:, :, c : c + chunk], device).to(device, non_blocking=True),
            gpu_engine._host_tensor(idx[c : c + chunk], device).to(device, non_blocking=True),
        )
        for c in range(0, pad_to, chunk)
    ]
    return [p for out in outs for p in gpu_engine.window_sums_to_points(out.cpu().numpy())][:m]


def msm_affine(points: Sequence[ExtPoint], scalars: Sequence[int], config: MSMConfig,
               device: torch.device) -> tuple[int, int]:
    entries = _host_bucket_entries(points, scalars)
    if not entries:
        return (0, 1)
    return _combine(entries, _device_products(entries, device))
