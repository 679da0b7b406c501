"""The Montgomery reduction as two constant-matrix products: constants and
plain PyTorch version.

The counterpart of the JAX package's `ops/pallas/field_kernels_mxu.py`
(`kmont_mul_mxu`). REDC needs m = (T mod 2^256) * N0' mod 2^256 and m * p;
both are linear in the bytes of their operand, so each is a constant matrix
times byte planes:

    m_cols  = M1 @ bytes(T_lo)     M1 [32, 32], Toeplitz in the bytes of N0'
    mp_cols = M2 @ bytes(m)        M2 [64, 32], Toeplitz in the bytes of p

The columns come out lazy (un-carried, each below 2^21) and are folded with
carries afterwards. The CUDA kernels `accumulate_scan_mma_kernel` and
`accumulate_scan_gather_mma_kernel` (`csrc/mma_kernels.cu`) compute the two
products with integer tensor-core `mma` on u8 operands; the plain version
here follows the same algorithm with float64 `torch.matmul`, exact far
beyond these sums.

The JAX package forms T as lazy 16-bit columns and multiplies three byte
planes per column by an M1 of [32, 48]; here T is normalized first, its low
half is 32 true bytes and M1 is [32, 32]. M2 is the same matrix in both.
R = 2^256 either way, so the residues are equal digit for digit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...oracle.field import N0_INV_256, P
from .. import field_ops, limbs
from ..limbs import DIGIT_BITS, DIGIT_MASK, N_DIGITS

N8 = 32  # bytes per 256-bit value


def _bytes_of(v: int) -> list[int]:
    return [(v >> (8 * k)) & 0xFF for k in range(N8)]


def _toeplitz(rows: int, digits: list[int]) -> np.ndarray:
    """[rows, 32] u8 with entry (o, c) = digits[o - c] where 0 <= o - c < 32:
    column o of the product of a 32-byte operand with the constant."""
    m = np.zeros((rows, N8), dtype=np.uint8)
    for o in range(rows):
        for c in range(N8):
            if 0 <= o - c < N8:
                m[o, c] = digits[o - c]
    return m


@functools.cache
def m1_matrix() -> np.ndarray:
    """[32, 32] u8: 32 bytes of T mod 2^256 -> 32 lazy byte columns of
    T * N0' mod 2^256 (products at byte 32 and above vanish mod 2^256)."""
    return _toeplitz(N8, _bytes_of(N0_INV_256))


@functools.cache
def m2_matrix() -> np.ndarray:
    """[64, 32] u8: 32 bytes of m -> 64 lazy byte columns of m * p."""
    return _toeplitz(2 * N8, _bytes_of(P))


@functools.cache
def _matrices_on(device: torch.device, dtype: torch.dtype):
    return tuple(torch.from_numpy(m.copy()).to(device=device, dtype=dtype)
                 for m in (m1_matrix(), m2_matrix()))


def const_inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(M1, M2) as row-major uint8 tensors on `device`: the kernel's two
    matrix arguments."""
    return _matrices_on(torch.device(device), torch.uint8)


def _matvec(mat: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """[O, I] float64 matrix times [I, *S] int64 planes -> [O, *S] int64."""
    flat = planes.reshape(planes.shape[0], -1).to(torch.float64)
    return torch.matmul(mat, flat).to(torch.int64).reshape((mat.shape[0],) + planes.shape[1:])


def _fold(cols: torch.Tensor, bits: int) -> torch.Tensor:
    """Lazy non-negative columns [n, *S] of weight 2^(bits*k) -> n true
    digits of `bits` bits; the carry out of the last digit is dropped."""
    mask = (1 << bits) - 1
    out, carry = [], 0
    for k in range(cols.shape[0]):
        s = cols[k] + carry
        out.append(s & mask)
        carry = s >> bits
    return torch.stack(out)


def mont_mul_mma_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p in [0, p) for a, b < p, on
    [16, *batch] int64 digit planes: `field_ops.mont_mul`'s contract and
    digits, by the matrix-form reduction."""
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    m1, m2 = _matrices_on(a.device, torch.float64)
    cols = torch.zeros((2 * N_DIGITS,) + tuple(shape), dtype=torch.int64, device=a.device)
    for i in range(N_DIGITS):
        cols[i : i + N_DIGITS] += a[i] * b
    t16 = _fold(cols, DIGIT_BITS)  # T = a*b < 2^512 as 32 true digits
    lo = t16[:N_DIGITS]
    t_bytes = torch.stack([lo & 0xFF, lo >> 8], dim=1).reshape((N8,) + tuple(shape))
    # m = (T mod 2^256) * N0' mod 2^256 as true bytes (m < 2^256 keeps
    # (T + m*p) / 2^256 below 2p).
    m8 = _fold(_matvec(m1, t_bytes), 8)
    mp8 = _matvec(m2, m8)  # 64 lazy byte columns of m * p
    mp16 = mp8[0::2] + (mp8[1::2] << 8)  # 32 lazy 16-bit columns
    total = _fold(t16 + mp16, DIGIT_BITS)  # T + m*p: the low 16 digits are zero
    return field_ops._cond_sub_p(total[N_DIGITS:])
