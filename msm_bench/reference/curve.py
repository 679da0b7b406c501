"""ed-on-bls12-377 in Python ints: frozen constants and a slow model.

The constants are copies of `webgpu_msm_tpu_torch/oracle/field.py` (P,
EDWARDS_D, SUBGROUP_ORDER) and `webgpu_msm_tpu_torch/oracle/testdata.py`
(the base point), frozen here so that a change to the program cannot move
the yardstick. The curve is -x^2 + y^2 = 1 + d x^2 y^2 over F_P.
"""
from __future__ import annotations

P = 8444461749428370424248824938781546531375899335154063827935233455917409239041
EDWARDS_A = P - 1
EDWARDS_D = 3021
SUBGROUP_ORDER = 2111115437357092606062206234695386632838870926408408195193685246394721360383
BASE_X = 2796670805570508460920584878396618987767121022598342527208237783066948667246
BASE_Y = 8134280397689638111748378379571739274369602049665521098046934931245960532166

IDENTITY = (0, 1, 0, 1)  # extended (X, Y, T, Z)


def ext(x: int, y: int) -> tuple[int, int, int, int]:
    return x % P, y % P, x * y % P, 1


def add(p1, p2):
    """Unified extended addition for a = -1 (add-2008-hwcd-3)."""
    x1, y1, t1, z1 = p1
    x2, y2, t2, z2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * EDWARDS_D * t1 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, e * h % P, f * g % P


def scalar_mul(p, k: int):
    """k * p by double-and-add, LSB first."""
    acc, addend = IDENTITY, p
    while k > 0:
        if k & 1:
            acc = add(acc, addend)
        addend = add(addend, addend)
        k >>= 1
    return acc


def affine(p) -> tuple[int, int]:
    zi = pow(p[3], -1, P)
    return p[0] * zi % P, p[1] * zi % P


def on_curve(x: int, y: int) -> bool:
    x2, y2 = x * x % P, y * y % P
    return (y2 - x2 - 1 - EDWARDS_D * x2 * y2) % P == 0


BASE = ext(BASE_X, BASE_Y)


def times_base(k: int) -> tuple[int, int]:
    """Affine k * BASE."""
    return affine(scalar_mul(BASE, k % SUBGROUP_ORDER))
