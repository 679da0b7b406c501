"""Pure-Python prime-field arithmetic for the ed-on-bls12-377 base field.

The port's own copy of the exact bigint oracle: the modulus is the 253-bit
BLS12-377 scalar-field prime, and every device result of this package is
tested against these functions.
"""
from __future__ import annotations

# Base field modulus of the twisted Edwards curve ed-on-bls12-377.
P = 8444461749428370424248824938781546531375899335154063827935233455917409239041

# Twisted Edwards curve coefficients: a = -1, d = 3021.
EDWARDS_A = P - 1
EDWARDS_D = 3021

# Order of the prime-order subgroup.
SUBGROUP_ORDER = 2111115437357092606062206234695386632838870926408408195193685246394721360383

# Montgomery parameters used by the device code (R = 2^256, independent of
# the limb size, so 16-bit digit planes and 32-bit kernel limbs agree).
R_BITS = 256
R = 1 << R_BITS
R_MOD_P = R % P
R2_MOD_P = (R * R) % P
R_INV_MOD_P = pow(R % P, P - 2, P)
# -p^{-1} mod 2^16 / 2^32 (per-digit and per-limb Montgomery constants).
N0_INV_16 = (-pow(P, -1, 1 << 16)) % (1 << 16)
N0_INV_32 = (-pow(P, -1, 1 << 32)) % (1 << 32)
# -p^{-1} mod 2^256: the whole-word constant of the matrix-form reduction.
N0_INV_256 = (-pow(P, -1, 1 << 256)) % (1 << 256)


def fadd(a: int, b: int) -> int:
    return (a + b) % P


def fsub(a: int, b: int) -> int:
    return (a - b) % P


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def fneg(a: int) -> int:
    return (-a) % P


def finv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("field inverse of zero")
    return pow(a, P - 2, P)


def fsqrt(a: int) -> int | None:
    """Tonelli-Shanks square root; returns None if `a` is a non-residue."""
    a %= P
    if a == 0:
        return 0
    if pow(a, (P - 1) // 2, P) != 1:
        return None
    # P - 1 = q * 2^s with q odd.
    q, s = P - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # Find a non-residue.
    z = 2
    while pow(z, (P - 1) // 2, P) != P - 1:
        z += 1
    m, c, t, r = s, pow(z, q, P), pow(a, q, P), pow(a, (q + 1) // 2, P)
    while t != 1:
        # Find least i, 0 < i < m, with t^(2^i) == 1.
        i, t2i = 0, t
        while t2i != 1:
            t2i = t2i * t2i % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m, c = i, b * b % P
        t = t * c % P
        r = r * b % P
    return r


def to_mont(a: int) -> int:
    """Map a -> a * R mod p (Montgomery domain)."""
    return (a * R) % P


def from_mont(a: int) -> int:
    """Map a*R -> a mod p."""
    return (a * R_INV_MOD_P) % P


def mont_mul(a: int, b: int) -> int:
    """Montgomery product (a*R)*(b*R) -> a*b*R mod p, via plain bigint math."""
    return (a * b * R_INV_MOD_P) % P
