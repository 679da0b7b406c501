"""The benchmark's inputs, made from the seed.

Points: the chain P_i = (k0 + i) * BASE for i < N, distinct subgroup
points with z = 1 and t = x * y whose discrete logs the benchmark knows.
They are made on the device in a few large calls: with N = J * M,
P_{j M + l} = A_j + B_l, where A_j = (k0 + j M) * BASE and B_l = l * BASE
(J + M points in Python ints), then one affine addition for each of the
N pairs in limb arithmetic, with the 2N denominators inverted together.

Scalars: 8 random u32 words reduced mod P (the reference harness's
draw: uniform below P up to a bias of P / 2^256), or, with `scalar_bits`
below 253, uniform below 2^scalar_bits.

An input set is the chain's rows in an order of its own (a permutation
drawn from the seed), or the fixed bases' one order, and scalars of its
own: nothing keyed on an array or its contents can stand in for the work.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import curve, field


@dataclass
class InputSet:
    points: np.ndarray  # [n, 32] big-endian u32 rows x || y || t || z
    scalars: np.ndarray  # [n, 8] big-endian u32 rows
    chain_index: np.ndarray  # [n] int64: row r holds (k0 + chain_index[r]) * BASE


@dataclass
class Inputs:
    k0: int
    sets: list[InputSet]


def _affine_chain(start, step, count: int) -> list[tuple[int, int]]:
    """Affine start, start + step, ... (count points), in Python ints."""
    out, p = [], start
    for _ in range(count):
        out.append(curve.affine(p))
        p = curve.add(p, step)
    return out


def chain_points(k0: int, n: int, device) -> torch.Tensor:
    """The rows of P_i = (k0 + i) * BASE, i < n, as [n, 32] int64 words
    (big-endian u32 values) on `device`."""
    M = 1 << math.ceil(math.log2(max(n, 2)) / 2)
    J = -(-n // M)
    A = _affine_chain(curve.scalar_mul(curve.BASE, k0), curve.scalar_mul(curve.BASE, M), J)
    B = _affine_chain(curve.IDENTITY, curve.BASE, M)
    mont = lambda v: field.to_mont(v, device)
    x1, y1 = (mont([p[c] for p in A]).repeat_interleave(M, dim=1)[:, :n] for c in (0, 1))
    x2, y2 = (mont([p[c] for p in B]).repeat(1, J)[:, :n] for c in (0, 1))
    mul = field.mont_mul
    x1x2, y1y2 = mul(x1, x2), mul(y1, y2)
    num_x = field.add(mul(x1, y2), mul(y1, x2))
    num_y = field.add(y1y2, x1x2)  # y1 y2 - a x1 x2 with a = -1
    del x1, y1, x2, y2
    dxy = mul(field.constant(curve.EDWARDS_D * field.R % curve.P, device), mul(x1x2, y1y2))
    one = field.constant(field.R % curve.P, device)
    inv = field.batch_inverse(torch.cat([field.add(one, dxy), field.sub(one, dxy)], dim=1))
    x, y = mul(num_x, inv[:, :n]), mul(num_y, inv[:, n:])
    xyt = [field.from_mont(c) for c in (x, y, mul(x, y))]
    return _wire_words(xyt)


def _wire_words(coords: list[torch.Tensor]) -> torch.Tensor:
    """[16, n] plain limbs per coordinate (x, y, t) -> [n, 32] BE u32 words,
    z = 1."""
    n = coords[0].shape[1]
    rows = torch.zeros((n, 32), dtype=torch.int64, device=coords[0].device)
    for c, v in enumerate(coords):
        words = v[0::2] | (v[1::2] << 16)  # [8, n] LE u32
        rows[:, 8 * c:8 * c + 8] = words.flip(0).t()
    rows[:, 31] = 1
    return rows


def random_scalars(gen: torch.Generator, n: int, scalar_bits: int, device) -> torch.Tensor:
    """[n, 8] int64 BE u32 words of scalars (see the module docstring)."""
    limbs = torch.randint(0, 1 << 16, (field.LIMBS, n), generator=gen, device=device, dtype=torch.int64)
    if scalar_bits >= 253:
        limbs = field.reduce_256(limbs)
    else:
        top, bit = divmod(scalar_bits, 16)
        limbs[top] &= (1 << bit) - 1
        limbs[top + 1:] = 0
    return (limbs[0::2] | (limbs[1::2] << 16)).flip(0).t()


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.int32).cpu().numpy().view(np.uint32)


def make_inputs(seed: int, sizes: list[int], n_sets: int, fixed_bases: bool, scalar_bits: int,
                device) -> Inputs:
    """n_sets input sets; set s has sizes[s % len(sizes)] points. With
    `fixed_bases` every set shares one point array (one order of the
    chain), as a plan's bases are fixed."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    N = max(sizes)
    # k0 + i for i < N stays in [1, SUBGROUP_ORDER): the logs are distinct.
    k0 = 1 + int.from_bytes(np.random.default_rng(seed).bytes(32), "big") % (curve.SUBGROUP_ORDER - N - 1)
    rows = chain_points(k0, N, device)
    sets, shared = [], None
    for s in range(n_sets):
        n = sizes[s % len(sizes)]
        if shared is None or not fixed_bases:
            perm = torch.randperm(N, generator=gen, device=device)[:n]
            shared = (_u32(rows[perm]), perm.cpu().numpy().astype(np.int64))
        scalars = _u32(random_scalars(gen, n, scalar_bits, device))
        sets.append(InputSet(points=shared[0], scalars=scalars, chain_index=shared[1]))
    return Inputs(k0=k0, sets=sets)
