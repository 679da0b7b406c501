"""Typed configuration for the port's MSM engine.

`MSMConfig` keeps the JAX package's field names and defaults for the knobs
the ported paths read. `resolved_wire_plan` is that package's rule, copied
as it is: it was swept on a TPU v5e, and nothing here says it is best on
an H100 — an H100 sweep of the rule is a later piece of work.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

SUPPORTED_WINDOW_SIZES = tuple(range(8, 21))


@dataclasses.dataclass(frozen=True)
class MSMConfig:
    """Configuration for a single MSM computation."""

    window_size: Optional[int] = None  # None -> resolved_wire_plan's rule
    # Accumulation chunking (lanes per window, steps per lane); both or
    # neither.
    n_chunks: Optional[int] = None
    chunk_len: Optional[int] = None
    # Signed (balanced) digits: bucket range 2^(w-1)+1 by negating points
    # on the fly. Needs scalars < 2^254; the engine checks and falls back.
    signed_digits: bool = True
    # Convert the window sums to affine on the device (a batched Fermat
    # inverse, `field_ops.finv_mont`) before the host combines them. Off by
    # default: a capability of the reference, not a speed-up.
    device_affine: bool = False

    def resolved_wire_plan(self, n_points: int) -> Tuple[int, int, int]:
        """(window, n_chunks, chunk_len) for host-fed wire inputs: batches
        of at most 2^18 points, w = 13 above 2^16 points."""
        if self.window_size is not None:
            w = self.window_size
        elif n_points <= (1 << 16):
            w = 12 if self.signed_digits else 11
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
