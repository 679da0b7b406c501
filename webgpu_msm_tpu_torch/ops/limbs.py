"""Digit-plane 256-bit integer arithmetic in plain PyTorch.

A batch of 256-bit values is a tensor [16, *batch]: plane k holds bits
[16k, 16k+16) of every element (little-endian digit order), as in the JAX
package. Arithmetic runs in int64, because torch's uint32 lacks + - >> on
the CPU: 16-bit digit products stay below 2^32 and lazy columns well below
2^63. At stage boundaries and kernel pointers the same bits travel as
int32 (see `as_i64` / `as_i32`).
"""
from __future__ import annotations

import functools

import torch

N_DIGITS = 16  # 16-bit digits per 256-bit value
DIGIT_BITS = 16
DIGIT_MASK = (1 << DIGIT_BITS) - 1
U32_MASK = 0xFFFFFFFF


def int_digits(value: int) -> list[int]:
    """Python-int digit list, least significant first."""
    return [(value >> (DIGIT_BITS * k)) & DIGIT_MASK for k in range(N_DIGITS)]


@functools.lru_cache(maxsize=None)
def _const(value: int, ndim: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(int_digits(value), dtype=torch.int64, device=device).reshape(
        (N_DIGITS,) + (1,) * ndim
    )


def const_planes(value: int, ndim: int, device) -> torch.Tensor:
    """[16, 1, ..., 1] int64 constant (ndim batch axes), cached per device."""
    return _const(value, ndim, torch.device(device))


def digits_of_int(value: int, shape, device) -> torch.Tensor:
    """A python-int constant broadcast to [16, *shape] int64 planes."""
    shape = tuple(shape)
    return const_planes(value, len(shape), device).expand((N_DIGITS,) + shape).clone()


def as_i64(t: torch.Tensor) -> torch.Tensor:
    """u32 bits held in an int32 (or int64) tensor -> int64 in [0, 2^32)."""
    return t.to(torch.int64) & U32_MASK


def as_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bits as int32."""
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


def from_words_le(words: torch.Tensor) -> torch.Tensor:
    """[8, *S] little-endian u32 words (int64) -> [16, *S] digit planes."""
    return torch.stack([words & DIGIT_MASK, words >> DIGIT_BITS], dim=1).reshape(
        (N_DIGITS,) + tuple(words.shape[1:])
    )


def to_words_le(digits: torch.Tensor) -> torch.Tensor:
    """[16, *S] digit planes -> [8, *S] little-endian u32 words (int64)."""
    return digits[0::2] | (digits[1::2] << DIGIT_BITS)


def stack(digits) -> torch.Tensor:
    """A sequence of 16 digit planes -> one [16, *S] tensor."""
    return torch.stack(list(digits))


def unstack(arr: torch.Tensor) -> list[torch.Tensor]:
    """[16, *S] -> the list of its 16 digit planes."""
    return list(arr.unbind(0))


def add_no_reduce(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2^256 with carry propagation."""
    out, carry = [], 0
    for k in range(N_DIGITS):
        s = a[k] + b[k] + carry
        out.append(s & DIGIT_MASK)
        carry = s >> DIGIT_BITS
    return torch.stack(out)


def sub_with_borrow(a: torch.Tensor, b: torch.Tensor):
    """((a - b) mod 2^256, borrow) with borrow 1 where a < b."""
    out, borrow = [], 0
    for k in range(N_DIGITS):
        d = a[k] - b[k] - borrow
        out.append(d & DIGIT_MASK)
        borrow = (d >> DIGIT_BITS) & 1
    return torch.stack(out), borrow


def sub_const_with_borrow(a: torch.Tensor, c: int):
    """((a - c) mod 2^256, borrow) for a python-int constant c, with borrow
    1 where a < c."""
    return sub_with_borrow(a, const_planes(c, a.dim() - 1, a.device).expand_as(a))


def propagate_carries(cols: torch.Tensor) -> torch.Tensor:
    """Normalize lazy non-negative columns [n, *S] to 16 digits; the carry
    out of digit 15 is dropped (callers keep values below 2^256)."""
    out, carry = [], 0
    for k in range(cols.shape[0]):
        s = cols[k] + carry
        if k < N_DIGITS:
            out.append(s & DIGIT_MASK)
        carry = s >> DIGIT_BITS
    return torch.stack(out)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise mask ? a : b over [16, *S] planes; mask is [*S] bool."""
    return torch.where(mask, a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)
