"""Deterministic MSM inputs and known-answer test cases.

`random_scalars` and `distinct_points_fast` reproduce the JAX package's
fixtures value for value, so `oracle.pinned_vectors.PINNED` applies. A
`TestCase` holds points, scalars and the expected affine result:
`repeated_base_case` (n copies of the base point, expected sum(s)·B, cheap
at any n), `distinct_case` (distinct points, expected from the serial
oracle MSM; for small n). `save_test_case` / `load_test_case` write and
read the reference's text fixture format.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np

from ..oracle import curve, field, msm as oracle_msm
from ..oracle.curve import ExtPoint
from ..oracle.testdata import base_point
from .convert import bigints_to_u32_be


@dataclass
class TestCase:
    points: list[ExtPoint]  # extended affine: z == 1, t == x*y
    scalars: list[int]
    expected: tuple[int, int]  # affine (x, y)


def random_scalars(n: int, seed: int = 0, bits: int = 253) -> list[int]:
    """Uniform scalars below the field modulus: 8 random u32 words per
    scalar, most significant word first, reduced mod p. `bits` is the
    reference's argument and, as there, does not change the values: every
    scalar is below p, a 253-bit bound."""
    raw = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    data = raw.astype(">u4").tobytes()
    return [int.from_bytes(data[i * 32 : (i + 1) * 32], "big") % field.P for i in range(n)]


def repeated_base_case(n: int, seed: int = 0) -> TestCase:
    """n copies of the pinned base point with random scalars; O(1) expected."""
    b = base_point()
    scalars = random_scalars(n, seed=seed)
    expected = curve.to_affine(curve.scalar_mul(b, sum(scalars)))
    return TestCase(points=[b] * n, scalars=scalars, expected=expected)


def distinct_points(n: int, seed: int = 1) -> list[ExtPoint]:
    """n distinct subgroup points: k_i * B for deterministic pseudorandom k_i
    (one scalar multiplication a point: for test sizes)."""
    b = base_point()
    pts = []
    for i in range(n):
        k = (
            int.from_bytes(hashlib.sha256(f"tpu-msm-point-{seed}-{i}".encode()).digest(), "big")
            % field.SUBGROUP_ORDER
        )
        pts.append(curve.from_affine(*curve.to_affine(curve.scalar_mul(b, k))))
    return pts


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


def distinct_case(n: int, seed: int = 1, window_size: int = 13) -> TestCase:
    """Distinct points + random scalars; expected via the serial oracle MSM."""
    pts = distinct_points(n, seed=seed)
    scalars = random_scalars(n, seed=seed + 1000)
    expected = curve.to_affine(oracle_msm.msm(pts, scalars, window_size))
    return TestCase(points=pts, scalars=scalars, expected=expected)


def save_test_case(case: TestCase, points_path, scalars_path) -> None:
    """Write fixture files in the reference's text format: one JSON point a
    line (x/y/t/z decimal strings) and one decimal scalar a line."""
    with open(points_path, "w") as f:
        for p in case.points:
            f.write(json.dumps({"x": str(p.x), "y": str(p.y), "t": str(p.t), "z": str(p.z)}) + "\n")
    with open(scalars_path, "w") as f:
        for s in case.scalars:
            f.write(f"{s}\n")


def load_test_case(points_path, scalars_path, expected=None) -> TestCase:
    """Read fixture files in `save_test_case`'s format (the reference's own
    fixture files have the same lines). `expected` may be given; else the
    oracle MSM at w 13 computes it."""
    pts = []
    with open(points_path) as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                pts.append(ExtPoint(int(d["x"]), int(d["y"]), int(d["t"]), int(d.get("z", 1))))
    with open(scalars_path) as f:
        scalars = [int(line) for line in f if line.strip()]
    if expected is None:
        expected = curve.to_affine(oracle_msm.msm(pts, scalars, 13))
    return TestCase(points=pts, scalars=scalars, expected=tuple(expected))


def wire_points(points: list[ExtPoint]) -> np.ndarray:
    """Extended-affine points -> [n, 32] big-endian u32 rows x || y || t || z."""
    return np.concatenate(
        [bigints_to_u32_be([getattr(p, c) for p in points]) for c in "xytz"], axis=1
    )
