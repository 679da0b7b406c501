"""Public API: `compute_msm`, the port's counterpart of the JAX package's.

Accepted inputs:
- points: a numpy [n, 32] array of big-endian u32 words (x||y||t||z), or
  a list of `ExtPoint`s, (x, y) or (x, y, t, z) int tuples;
- scalars: a numpy [n, 8] big-endian u32 array, or a list of ints.

Everything runs through the wire path of `engines/gpu_engine.py`: lists,
and wire rows with z != 1, are first marshalled on the host into z == 1
wire rows. The computation runs on `device`: the GPU when none is given
(an error without one), the plain PyTorch path only for device="cpu".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from .config import MSMConfig
from .engines import gpu_engine
from .oracle import curve, field
from .oracle.curve import ExtPoint
from .utils import convert


@dataclass(frozen=True)
class AffinePoint:
    x: int
    y: int


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1: {item})")


def _to_ext_points(points: Any) -> list[ExtPoint]:
    if isinstance(points, np.ndarray):
        arr = convert.as_u32_array(points, "points").reshape(-1, 32)
        words = [convert.be_rows_to_words_le(arr[:, 8 * c : 8 * c + 8]) for c in range(4)]
        return [ExtPoint(*v) for v in zip(*(convert.words_le_to_bigints(w) for w in words))]
    out = []
    for p in points:
        if isinstance(p, ExtPoint):
            out.append(p)
        elif isinstance(p, (tuple, list)) and len(p) == 2:
            out.append(curve.from_affine(int(p[0]), int(p[1])))
        elif isinstance(p, (tuple, list)) and len(p) == 4:
            out.append(ExtPoint(*(int(v) for v in p)))
        else:
            raise _not_ported(f"point input of type {type(p).__name__}", "other input forms")
    return out


def _marshal_points(points: list[ExtPoint]) -> np.ndarray:
    """Extended points -> [n, 32] BE u32 wire rows with z == 1 (z != 1 is
    normalized on the host)."""
    xs, ys, ts = [], [], []
    for p in points:
        if p.z % field.P != 1:
            zi = field.finv(p.z)
            x, y = p.x * zi % field.P, p.y * zi % field.P
            t = x * y % field.P
        else:
            x, y, t = p.x % field.P, p.y % field.P, p.t % field.P
        xs.append(x)
        ys.append(y)
        ts.append(t)
    rows = np.zeros((len(points), 32), dtype=np.uint32)
    rows[:, 0:8] = convert.bigints_to_u32_be(xs)
    rows[:, 8:16] = convert.bigints_to_u32_be(ys)
    rows[:, 16:24] = convert.bigints_to_u32_be(ts)
    rows[:, 31] = 1
    return rows


def _z_is_one(rows: np.ndarray) -> bool:
    z = rows[:, 24:32]
    return bool(np.all(z[:, :7] == 0) and np.all(z[:, 7] == 1))


def compute_msm(
    points: Any,
    scalars: Any,
    config: Optional[MSMConfig] = None,
    device=None,
    engine: Optional[str] = None,
) -> AffinePoint:
    """Compute sum_i scalars[i] * points[i]; returns the affine result.

    device: a torch device ("cuda", "cuda:0", "cpu"); None means the GPU.
    engine: None or "gpu"; the JAX package's other engines are not ported.
    """
    if engine not in (None, "gpu"):
        raise _not_ported(f"engine {engine!r}", "other engines")
    config = config or MSMConfig()
    dev = gpu_engine.resolve_device(device)

    if isinstance(points, np.ndarray):
        rows = convert.as_u32_array(points, "wire points")
        if rows.size % 32:
            raise ValueError(f"wire points: {rows.size} words is not a whole number of rows")
        rows = rows.reshape(-1, 32)
        if not _z_is_one(rows):
            rows = _marshal_points(_to_ext_points(rows))
    elif isinstance(points, dict):
        raise _not_ported("dict-of-arrays point input", "other input forms")
    else:
        rows = _marshal_points(_to_ext_points(points))

    if isinstance(scalars, np.ndarray):
        sc = convert.as_u32_array(scalars, "wire scalars")
        if sc.size % 8:
            raise ValueError(f"wire scalars: {sc.size} words is not a whole number of rows")
        sc = sc.reshape(-1, 8)
    else:
        sc = convert.bigints_to_u32_be([int(s) for s in scalars])

    if rows.shape[0] != sc.shape[0]:
        raise ValueError(f"points/scalars length mismatch: {rows.shape[0]} vs {sc.shape[0]}")
    if rows.shape[0] == 0:
        return AffinePoint(0, 1)
    x, y = gpu_engine.msm_affine_wire(rows, sc, config, dev)
    return AffinePoint(x, y)
