"""Extended twisted Edwards point ops over digit planes, plain PyTorch.

The counterpart of the JAX package's `ops/curve_ops.py`: the same
formulas in the same order (unified add-2008-hwcd-3 and dbl-2008-hwcd with
a = -1, d = 3021), so results agree digit for digit. A point batch is a
`PointVec` of four [16, *batch] int64 Montgomery-domain coordinates; its
stacked form is [4, 16, *batch].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..oracle.field import EDWARDS_D, R_MOD_P
from . import field_ops, limbs
from .field_ops import field_add, field_neg, field_sub, mont_mul, mont_sqr, mul_plain_const


class PointVec(NamedTuple):
    """Batch of extended points; each coordinate is [16, *batch] planes."""

    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    z: torch.Tensor

    def stacked(self) -> torch.Tensor:
        """[4, 16, *batch]."""
        return torch.stack([self.x, self.y, self.t, self.z])

    @staticmethod
    def from_stacked(arr: torch.Tensor) -> "PointVec":
        return PointVec(arr[0], arr[1], arr[2], arr[3])


def identity(shape=(), device="cpu") -> PointVec:
    """(0, 1, 0, 1) in the Montgomery domain: (0, R, 0, R)."""
    zero = limbs.digits_of_int(0, shape, device)
    one = limbs.digits_of_int(R_MOD_P, shape, device)
    return PointVec(zero, one, zero.clone(), one.clone())


def add(p1: PointVec, p2: PointVec) -> PointVec:
    """Unified addition (add-2008-hwcd-3, a = -1); complete on the subgroup."""
    a = mont_mul(field_sub(p1.y, p1.x), field_sub(p2.y, p2.x))
    b = mont_mul(field_add(p1.y, p1.x), field_add(p2.y, p2.x))
    c = mul_plain_const(mont_mul(p1.t, p2.t), 2 * EDWARDS_D)
    zz = mont_mul(p1.z, p2.z)
    d = field_add(zz, zz)
    e = field_sub(b, a)
    f = field_sub(d, c)
    g = field_add(d, c)
    h = field_add(b, a)
    return PointVec(mont_mul(e, f), mont_mul(g, h), mont_mul(e, h), mont_mul(f, g))


def add_mixed(p1: PointVec, p2_x, p2_y, p2_t) -> PointVec:
    """p1 + p2 with p2.z == 1 (Montgomery R): the unified add without the
    Z1*Z2 product."""
    a = mont_mul(field_sub(p1.y, p1.x), field_sub(p2_y, p2_x))
    b = mont_mul(field_add(p1.y, p1.x), field_add(p2_y, p2_x))
    c = mul_plain_const(mont_mul(p1.t, p2_t), 2 * EDWARDS_D)
    d = field_add(p1.z, p1.z)  # 2 * Z1 * 1
    e = field_sub(b, a)
    f = field_sub(d, c)
    g = field_add(d, c)
    h = field_add(b, a)
    return PointVec(mont_mul(e, f), mont_mul(g, h), mont_mul(e, h), mont_mul(f, g))


def add_niels(p1: PointVec, ym2, yp2, td2, mul=mont_mul) -> PointVec:
    """p1 + p2 with p2 in Niels form (y-x, y+x, 2d*t; z == 1): 7 multiplies,
    each through `mul`, a Montgomery product with `mont_mul`'s contract."""
    a = mul(field_sub(p1.y, p1.x), ym2)
    b = mul(field_add(p1.y, p1.x), yp2)
    c = mul(p1.t, td2)
    d = field_add(p1.z, p1.z)
    e = field_sub(b, a)
    f = field_sub(d, c)
    g = field_add(d, c)
    h = field_add(b, a)
    return PointVec(mul(e, f), mul(g, h), mul(e, h), mul(f, g))


def to_niels_planes(points_plain: torch.Tensor) -> torch.Tensor:
    """[3, 16, n] plain (x, y, t) digit planes (values below p) ->
    [3, 16, n] Montgomery Niels planes (y-x, y+x, 2d*t)."""
    x = field_ops.to_mont(points_plain[0])
    y = field_ops.to_mont(points_plain[1])
    t = field_ops.to_mont(points_plain[2])
    return torch.stack([field_sub(y, x), field_add(y, x), mul_plain_const(t, 2 * EDWARDS_D)])


def to_niels_from_xy(x_planes: torch.Tensor, y_planes: torch.Tensor) -> torch.Tensor:
    """[16, n] plain x and y digit planes -> [3, 16, n] Montgomery Niels
    (y-x, y+x, 2d*t) with t = x*y computed as mont_mul(xR, yR)."""
    x = field_ops.to_mont(x_planes)
    y = field_ops.to_mont(y_planes)
    td = mul_plain_const(mont_mul(x, y), 2 * EDWARDS_D)
    return torch.stack([field_sub(y, x), field_add(y, x), td])


def double(p: PointVec) -> PointVec:
    """Dedicated doubling (dbl-2008-hwcd, a = -1)."""
    a = mont_sqr(p.x)
    b = mont_sqr(p.y)
    zz = mont_sqr(p.z)
    c = field_add(zz, zz)
    d = field_neg(a)
    h = field_sub(d, b)
    e = field_add(mont_sqr(field_add(p.x, p.y)), h)
    g = field_add(d, b)
    f = field_sub(g, c)
    return PointVec(mont_mul(e, f), mont_mul(g, h), mont_mul(e, h), mont_mul(f, g))


def select(mask: torch.Tensor, a: PointVec, b: PointVec) -> PointVec:
    """Per-lane: mask ? a : b."""
    return PointVec(*(limbs.select(mask, u, v) for u, v in zip(a, b)))


def to_mont(p: PointVec) -> PointVec:
    """Each coordinate a -> a*R mod p."""
    return PointVec(*(field_ops.to_mont(c) for c in p))


def from_mont(p: PointVec) -> PointVec:
    """Each coordinate a*R -> a mod p."""
    return PointVec(*(field_ops.from_mont(c) for c in p))
