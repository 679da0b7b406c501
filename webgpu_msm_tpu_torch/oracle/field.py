"""Pure-Python prime-field arithmetic for the ed-on-bls12-377 base field.

The port's own copy of the exact bigint oracle: the modulus is the 253-bit
BLS12-377 scalar-field prime, and every device result of this package is
tested against these functions.
"""
from __future__ import annotations

# Base field modulus of the twisted Edwards curve ed-on-bls12-377.
P = 8444461749428370424248824938781546531375899335154063827935233455917409239041

# Twisted Edwards curve coefficient d (a = -1).
EDWARDS_D = 3021

# Order of the prime-order subgroup.
SUBGROUP_ORDER = 2111115437357092606062206234695386632838870926408408195193685246394721360383

# Montgomery parameters used by the device code (R = 2^256, independent of
# the limb size, so 16-bit digit planes and 32-bit kernel limbs agree).
R = 1 << 256
R_MOD_P = R % P
R2_MOD_P = (R * R) % P
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
