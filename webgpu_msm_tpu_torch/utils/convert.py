"""Input marshalling: bigint <-> u32 numpy arrays.

The wire format is 8 big-endian u32 words per 256-bit value ([n, 8] rows);
the device layout is little-endian u32 words, [8, n] word planes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

N_WORDS = 8  # u32 words per 256-bit value
SCALAR_BITS = 256


def bigints_to_u32_be(values: Sequence[int]) -> np.ndarray:
    """[n] python ints (< 2^256) -> [n, 8] big-endian u32 wire rows."""
    data = b"".join(int(v).to_bytes(32, "big") for v in values)
    return np.frombuffer(data, dtype=">u4").astype(np.uint32).reshape(-1, N_WORDS)


def as_u32_array(arr: np.ndarray, what: str = "input") -> np.ndarray:
    """Convert an integer array to uint32, rejecting out-of-range values
    (a cast would silently truncate a wider array into a wrong MSM)."""
    a = np.asarray(arr)
    if a.dtype == np.uint32:
        return a
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"{what}: expected an integer array, got dtype {a.dtype}")
    if a.size and (int(a.min()) < 0 or int(a.max()) > 0xFFFFFFFF):
        raise ValueError(
            f"{what}: values outside u32 range in a {a.dtype} array; "
            "wire-format words must each fit in 32 bits"
        )
    return a.astype(np.uint32)


def u32_be_to_bigints(arr: np.ndarray) -> list[int]:
    """[n, 8] big-endian u32 wire rows -> python ints."""
    arr = as_u32_array(arr, "u32 BE rows").reshape(-1, N_WORDS)
    data = arr.astype(">u4").tobytes()
    return [int.from_bytes(data[i * 32 : (i + 1) * 32], "big") for i in range(arr.shape[0])]


def bigints_to_words_le(values: Sequence[int]) -> np.ndarray:
    """[n] python ints (< 2^256) -> [8, n] little-endian u32 word planes."""
    data = b"".join(int(v).to_bytes(32, "little") for v in values)
    words = np.frombuffer(data, dtype="<u4").astype(np.uint32).reshape(-1, N_WORDS)
    return np.ascontiguousarray(words.T)


def words_le_to_bigints(arr: np.ndarray) -> list[int]:
    """[8, n] little-endian u32 word planes -> python ints."""
    arr = np.asarray(arr, dtype=np.uint32)
    if arr.ndim == 1:
        arr = arr[:, None]
    assert arr.shape[0] == N_WORDS
    data = np.ascontiguousarray(arr.T).astype("<u4").tobytes()
    return [
        int.from_bytes(data[i * 32 : (i + 1) * 32], "little")
        for i in range(arr.shape[1])
    ]


def be_rows_to_words_le(arr: np.ndarray) -> np.ndarray:
    """[n, 8] big-endian rows (wire format) -> [8, n] little-endian planes."""
    arr = np.asarray(arr, dtype=np.uint32).reshape(-1, N_WORDS)
    return np.ascontiguousarray(arr[:, ::-1].T)


def words_le_to_be_rows(arr: np.ndarray) -> np.ndarray:
    """[8, n] little-endian planes -> [n, 8] big-endian rows."""
    arr = np.asarray(arr, dtype=np.uint32)
    return np.ascontiguousarray(arr.T[:, ::-1])


def points_to_words_le(
    xs: Sequence[int], ys: Sequence[int], ts: Sequence[int], zs: Sequence[int]
) -> np.ndarray:
    """Four coordinate lists -> [4, 8, n] LE word planes (x, y, t, z)."""
    return np.stack([bigints_to_words_le(c) for c in (xs, ys, ts, zs)])
