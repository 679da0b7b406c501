"""Pure-Python extended twisted Edwards curve ops (ed-on-bls12-377).

Points are (X, Y, T, Z) extended coordinates with x = X/Z, y = Y/Z,
T = X*Y/Z; the identity is (0, 1, 0, 1). The add is the unified
add-2008-hwcd-3 form (a = -1) the device code uses, so kernel results can
be compared coordinate for coordinate.
"""
from __future__ import annotations

from dataclasses import dataclass

from .field import P, EDWARDS_D, fadd, fsub, fmul, fneg, finv


@dataclass(frozen=True)
class ExtPoint:
    x: int
    y: int
    t: int
    z: int

    def __add__(self, other: "ExtPoint") -> "ExtPoint":
        return add(self, other)


IDENTITY = ExtPoint(0, 1, 0, 1)


def from_affine(x: int, y: int) -> ExtPoint:
    return ExtPoint(x % P, y % P, x * y % P, 1)


def to_affine(p: ExtPoint) -> tuple[int, int]:
    zinv = finv(p.z)
    return (fmul(p.x, zinv), fmul(p.y, zinv))


def add(p1: ExtPoint, p2: ExtPoint) -> ExtPoint:
    """Unified extended twisted Edwards addition (a = -1, add-2008-hwcd-3)."""
    a = fmul(fsub(p1.y, p1.x), fsub(p2.y, p2.x))
    b = fmul(fadd(p1.y, p1.x), fadd(p2.y, p2.x))
    c = fmul(2 * EDWARDS_D, fmul(p1.t, p2.t))
    zz = fmul(p1.z, p2.z)
    d = fadd(zz, zz)
    e = fsub(b, a)
    f = fsub(d, c)
    g = fadd(d, c)
    h = fadd(b, a)
    return ExtPoint(fmul(e, f), fmul(g, h), fmul(e, h), fmul(f, g))


def double(p: ExtPoint) -> ExtPoint:
    """Dedicated doubling (dbl-2008-hwcd for a = -1)."""
    a = fmul(p.x, p.x)
    b = fmul(p.y, p.y)
    c = fadd(fmul(p.z, p.z), fmul(p.z, p.z))
    d = fneg(a)  # a * A with a = -1
    h = fsub(d, b)
    e = fadd(fmul(fadd(p.x, p.y), fadd(p.x, p.y)), h)
    g = fadd(d, b)
    f = fsub(g, c)
    return ExtPoint(fmul(e, f), fmul(g, h), fmul(e, h), fmul(f, g))


def neg(p: ExtPoint) -> ExtPoint:
    return ExtPoint(fneg(p.x), p.y, fneg(p.t), p.z)


def scalar_mul(p: ExtPoint, k: int) -> ExtPoint:
    """Double-and-add scalar multiplication (LSB-first)."""
    result = IDENTITY
    addend = p
    while k > 0:
        if k & 1:
            result = add(result, addend)
        addend = double(addend)
        k >>= 1
    return result


def is_on_curve(p: ExtPoint) -> bool:
    """Check -x^2 + y^2 == z^2 + d*t^2 and t*z == x*y (projectively)."""
    x2 = fmul(p.x, p.x)
    y2 = fmul(p.y, p.y)
    z2 = fmul(p.z, p.z)
    t2 = fmul(p.t, p.t)
    lhs = fsub(y2, x2)
    rhs = fadd(z2, fmul(EDWARDS_D, t2))
    return lhs == rhs and fmul(p.t, p.z) == fmul(p.x, p.y)


def eq(p1: ExtPoint, p2: ExtPoint) -> bool:
    """Projective equality: x1/z1 == x2/z2 and y1/z1 == y2/z2."""
    return (
        fmul(p1.x, p2.z) == fmul(p2.x, p1.z)
        and fmul(p1.y, p2.z) == fmul(p2.y, p1.z)
    )
