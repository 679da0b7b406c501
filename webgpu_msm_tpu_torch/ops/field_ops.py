"""Fp arithmetic in the Montgomery domain, plain PyTorch over digit planes.

The counterpart of the JAX package's `ops/field_ops.py`. Operands are
[16, *batch] int64 digit planes of values in [0, p); R = 2^256. Every
result is fully reduced to [0, p), so any correct Montgomery product gives
the same digits: these functions agree digit for digit with the JAX
package and with the CUDA kernels' 32-bit-limb arithmetic.

This is the plain version behind every kernel of `ops/kernels`; the Gs 1
reduction runs its `from_mont` on the card (where the JAX package, too,
uses jnp and not Pallas).
"""
from __future__ import annotations

import torch

from ..oracle.field import N0_INV_16, P, R, R2_MOD_P, R_MOD_P
from . import limbs
from .limbs import DIGIT_BITS, DIGIT_MASK, N_DIGITS

_N0 = int(N0_INV_16)


def _cond_sub_p(a: torch.Tensor) -> torch.Tensor:
    """a in [0, 2p) -> a mod p."""
    d, borrow = limbs.sub_const_with_borrow(a, P)
    return limbs.select(borrow == 1, a, d)


def field_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for a, b < p."""
    return _cond_sub_p(limbs.add_no_reduce(a, b))


def field_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for a, b < p."""
    d, borrow = limbs.sub_with_borrow(a, b)
    p = limbs.const_planes(P, d.dim() - 1, d.device)
    return limbs.select(borrow == 1, limbs.add_no_reduce(d, p.expand_as(d)), d)


def field_double(a: torch.Tensor) -> torch.Tensor:
    return field_add(a, a)


def field_neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p; maps 0 to 0."""
    p = limbs.const_planes(P, a.dim() - 1, a.device)
    p_minus_a, _ = limbs.sub_with_borrow(p.expand_as(a), a)
    return limbs.select(limbs.is_zero(a), a, p_minus_a)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p, in [0, p), for a < 2^256 and
    b < p (b may be a broadcast constant).

    Lazy product columns (each a sum of at most 16 digit products), then a
    digit-serial Montgomery reduction: m_i = col_i * (-p^-1) mod 2^16 makes
    column i divisible by 2^16 and its carry moves up. The result is below
    2p and one conditional subtraction finishes it.
    """
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    cols = torch.zeros((2 * N_DIGITS,) + tuple(shape), dtype=torch.int64, device=a.device)
    for i in range(N_DIGITS):
        cols[i : i + N_DIGITS] += a[i] * b
    p = limbs.const_planes(P, len(shape), a.device)
    for i in range(N_DIGITS):
        m = ((cols[i] & DIGIT_MASK) * _N0) & DIGIT_MASK
        cols[i : i + N_DIGITS] += m * p
        cols[i + 1] += cols[i] >> DIGIT_BITS
    return _cond_sub_p(limbs.propagate_carries(cols[N_DIGITS:]))


def mont_sqr(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, a)


def mont_mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    """Montgomery product with a python-int constant: (a*c*R^-1) mod p."""
    return mont_mul(a, limbs.const_planes(c % P, a.dim() - 1, a.device))


def mul_plain_const(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod p for a constant k, staying in the Montgomery domain."""
    return mont_mul_const(a, (k * R) % P)


def mont_pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a*R -> (a^e)*R for a python-int exponent e >= 0.

    Left-to-right square-and-multiply over the bits of e: one square a bit
    and one product where the bit is set (the JAX package computes both
    every step and selects, since its loop is traced once; the digits are
    the same). Plain PyTorch on `a`'s device.
    """
    acc = limbs.digits_of_int(R_MOD_P, a.shape[1:], a.device)  # Montgomery 1
    for i in reversed(range(e.bit_length())):
        acc = mont_sqr(acc)
        if (e >> i) & 1:
            acc = mont_mul(acc, a)
    return acc


def finv_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery-domain inverse a*R -> (a^-1)*R by Fermat (e = p - 2);
    maps 0 to 0."""
    return mont_pow_const(a, P - 2)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """a -> a*R mod p (constant multiply by R^2)."""
    return mont_mul_const(a, R2_MOD_P)


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """a*R -> a mod p (REDC with multiplier 1)."""
    return mont_mul_const(a, 1)
