"""Deterministic MSM inputs: the seeds behind the pinned 2^16..2^20 results.

`random_scalars` and `distinct_points_fast` reproduce the JAX package's
fixtures value for value, so `oracle.pinned_vectors.PINNED` applies.
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..oracle import curve, field
from ..oracle.curve import ExtPoint
from ..oracle.testdata import base_point
from .convert import bigints_to_u32_be


def random_scalars(n: int, seed: int = 0) -> list[int]:
    """Uniform scalars below the field modulus: 8 random u32 words per
    scalar, most significant word first, reduced mod p."""
    raw = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    data = raw.astype(">u4").tobytes()
    return [int.from_bytes(data[i * 32 : (i + 1) * 32], "big") % field.P for i in range(n)]


def distinct_points_fast(n: int, seed: int = 1) -> list[ExtPoint]:
    """n distinct subgroup points P_i = (k0 + i)·B at full size.

    One group add per point and one batched (Montgomery-trick) inversion
    to affine. Point values do not steer the MSM's control flow (only the
    scalars do), so the chain costs no coverage.
    """
    b = base_point()
    k0 = (
        int.from_bytes(hashlib.sha256(f"tpu-msm-chain-{seed}".encode()).digest(), "big")
        % field.SUBGROUP_ORDER
    )
    p = curve.scalar_mul(b, k0)
    chain = []
    for _ in range(n):
        chain.append(p)
        p = curve.add(p, b)
    prefix = [1] * (n + 1)
    for i, q in enumerate(chain):
        prefix[i + 1] = prefix[i] * q.z % field.P
    inv = field.finv(prefix[n])
    zinvs = [0] * n
    for i in range(n - 1, -1, -1):
        zinvs[i] = prefix[i] * inv % field.P
        inv = inv * chain[i].z % field.P
    out = []
    for q, zi in zip(chain, zinvs):
        x = q.x * zi % field.P
        y = q.y * zi % field.P
        out.append(ExtPoint(x, y, x * y % field.P, 1))
    return out


def wire_points(points: list[ExtPoint]) -> np.ndarray:
    """Extended-affine points -> [n, 32] big-endian u32 rows x || y || t || z."""
    return np.concatenate(
        [bigints_to_u32_be([getattr(p, c) for p in points]) for c in "xytz"], axis=1
    )
