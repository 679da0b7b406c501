"""Typed configuration for the port's MSM engines.

`MSMConfig` keeps the JAX package's field names and defaults for the knobs
the ported engines read, and the window and chunking rules are that
package's, copied as they are: they were swept on a TPU v5e, and nothing
here says they are best on an H100 (an H100 sweep is a later piece of
work). One difference is deliberate: `resolved_wire_plan` rejects a window
size outside `SUPPORTED_WINDOW_SIZES`, where the JAX one takes any.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

SUPPORTED_WINDOW_SIZES = tuple(range(8, 21))


def best_window_size(n_points: int) -> int:
    """Auto window size: 11 for <= 2^16, 12 for 2^17..2^19, 13 for >= 2^20
    (the reference's rule)."""
    if n_points <= (1 << 16):
        return 11
    if n_points < (1 << 20):
        return 12
    return 13


def best_window_size_signed(n_points: int) -> int:
    """Auto window size for signed digits on device-resident inputs: 12 up
    to 2^16, 13 up to 2^20, 16 from 2^20 (the JAX package's TPU sweep)."""
    if n_points >= (1 << 20):
        return 16
    if n_points <= (1 << 16):
        return 12
    return 13


def default_chunking(n_points: int) -> Tuple[int, int]:
    """(n_chunks, chunk_len) with n_chunks * chunk_len >= n_points: powers
    of two, one batch of at most 2^20 points, at most 2^11 lanes."""
    if n_points <= 0:
        raise ValueError("n_points must be positive")
    bits = max(1, math.ceil(math.log2(n_points)))
    bits = min(bits, 20)
    n_chunks = 1 << min(math.ceil(bits * 0.6), 11)
    n_chunks = min(n_chunks, 1 << bits)
    chunk_len = (1 << bits) // n_chunks
    return n_chunks, chunk_len


@dataclasses.dataclass(frozen=True)
class MSMConfig:
    """Configuration for a single MSM computation."""

    window_size: Optional[int] = None  # None -> the engine's rule
    # Share of the points in [0, 1] that the native CPU engine computes
    # while the GPU computes the rest (the reference's cpuWorkRatio).
    cpu_work_ratio: float = 0.0
    # Accumulation chunking (lanes per window, steps per lane); both or
    # neither.
    n_chunks: Optional[int] = None
    chunk_len: Optional[int] = None
    # Signed (balanced) digits: bucket range 2^(w-1)+1 by negating points
    # on the fly. Needs scalars < 2^254; the engine checks and falls back.
    signed_digits: bool = True
    # Native-engine threads. None: every hardware thread for the CPU engine
    # alone, all but one beside the GPU (the reference's idle-thread
    # reservation, which keeps the thread that feeds the device free).
    cpu_threads: Optional[int] = None
    # Convert the window sums to affine on the device (a divstep inverse a
    # window, the `finish_affine_divsteps` kernel) before the host combines
    # them. Off by default: a capability of the reference, not a speed-up.
    device_affine: bool = False
    # Multi-GPU (`parallel/msm_sharded.py`): what the shards all-gather.
    #   "window_sums": each shard's window sums (K points a shard); default
    #   "buckets":     each shard's bucket sums, tree-added, reduced once
    collective_mode: str = "window_sums"

    def resolved_window_size(self, n_points: int) -> int:
        """Window size for device-resident inputs, and the oracle's."""
        if self.window_size is not None:
            w = self.window_size
        elif self.signed_digits:
            w = best_window_size_signed(n_points)
        else:
            w = best_window_size(n_points)
        if w not in SUPPORTED_WINDOW_SIZES:
            raise ValueError(f"unsupported window size {w}; supported: {SUPPORTED_WINDOW_SIZES}")
        return w

    def resolved_window_size_native(self, n_points: int) -> int:
        """Window size for the native CPU engine, alone or as the CPU share
        of a split: a serial CPU pays the whole running sum of 2^(w-1)
        buckets a window a thread, so the reference's 11/12/13 rule stays
        right for it. Each engine of a split resolves its own window."""
        if self.window_size is not None:
            return self.window_size
        return best_window_size(n_points)

    def resolved_chunking(self, n_points: int) -> Tuple[int, int]:
        if self.n_chunks is not None and self.chunk_len is not None:
            return self.n_chunks, self.chunk_len
        return default_chunking(n_points)

    def resolved_wire_plan(self, n_points: int) -> Tuple[int, int, int]:
        """(window, n_chunks, chunk_len) for host-fed wire inputs: batches
        of at most 2^18 points, w = 13 above 2^16 points."""
        if self.window_size is not None:
            w = self.window_size
        elif n_points <= (1 << 16):
            w = 12 if self.signed_digits else best_window_size(n_points)
        else:
            w = 13
        if w not in SUPPORTED_WINDOW_SIZES:
            raise ValueError(f"unsupported window size {w}; supported: {SUPPORTED_WINDOW_SIZES}")
        if self.n_chunks is not None and self.chunk_len is not None:
            return w, self.n_chunks, self.chunk_len
        bits = max(1, math.ceil(math.log2(max(n_points, 1))))
        bits = min(bits, 18)
        n_chunks = 1 << min(math.ceil(bits * 0.6), 13)
        n_chunks = min(n_chunks, 1 << bits)
        return w, n_chunks, (1 << bits) // n_chunks
