"""Windowed scalar decomposition, plain PyTorch (int64).

Scalars arrive as [8, n] little-endian u32 word planes (int64); the output
is the [n_windows, n] digit matrix, window k holding bits [k*w, (k+1)*w),
as in the JAX package's `ops/windows.py`.
"""
from __future__ import annotations

import torch

SCALAR_BITS = 256
WORD_BITS = 32
N_WORDS = 8


def n_windows(window_size: int) -> int:
    return -(-SCALAR_BITS // window_size)


def split_windows(scalar_words: torch.Tensor, window_size: int) -> torch.Tensor:
    """[8, n] LE u32 words (int64) -> [n_windows, n] int64 digits."""
    w = window_size
    mask = (1 << w) - 1
    rows = []
    for k in range(n_windows(w)):
        bit0 = k * w
        word, off = divmod(bit0, WORD_BITS)
        val = scalar_words[word] >> off
        if off + w > WORD_BITS and word + 1 < N_WORDS:
            val = val | (scalar_words[word + 1] << (WORD_BITS - off))
        rows.append(val & mask)
    return torch.stack(rows)


def split_windows_signed(
    scalar_words: torch.Tensor, window_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed (balanced) digits in [-2^(w-1), 2^(w-1)].

    Returns (buckets [K, n] = |digit|, signs [K, n] in {0, 1}); a digit
    at or above 2^(w-1) becomes 2^w - v with a carry into the next window.
    Needs scalars < 2^254 so the top window cannot carry out.
    """
    w = window_size
    digits = split_windows(scalar_words, w)
    half, full = 1 << (w - 1), 1 << w
    buckets, signs = [], []
    carry = torch.zeros_like(digits[0])
    for k in range(n_windows(w)):
        v = digits[k] + carry
        neg = v >= half
        buckets.append(torch.where(neg, full - v, v))
        carry = neg.to(torch.int64)
        signs.append(carry)
    return torch.stack(buckets), torch.stack(signs)
