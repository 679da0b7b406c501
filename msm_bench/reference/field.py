"""F_P in plain PyTorch: limb-first int64 tensors on any device.

An element is a column of 16 little-endian 16-bit limbs: a tensor
[16, n] holds n elements, limb i in row i (rows are contiguous, so each
step below is one pass over n values). Products use the Montgomery form
with R = 2^256. Every column sum stays below 2^38, far inside int64.

This is the benchmark's own arithmetic for making inputs on the card in a
few large calls; it shares nothing with the program's kernels.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .curve import P

LIMBS = 16
MASK = 0xFFFF
R = 1 << 256
N0 = (-pow(P, -1, 1 << 16)) % (1 << 16)  # -P^-1 mod 2^16
HOST_LEVEL = 1 << 12  # a product tree's narrowest levels cost more in launches than in Python ints


def to_limbs(values: list[int], device) -> torch.Tensor:
    """Python ints below 2^256 -> [16, n] int64 limbs."""
    raw = b"".join(v.to_bytes(32, "little") for v in values)
    limbs = np.frombuffer(raw, dtype="<u2").reshape(-1, LIMBS).T.astype(np.int64)
    return torch.from_numpy(limbs).to(device)


def from_limbs(t: torch.Tensor) -> list[int]:
    """[16, n] limbs, each in [0, 2^16) -> Python ints."""
    raw = t.cpu().numpy().astype("<u2").T.tobytes()
    return [int.from_bytes(raw[j:j + 32], "little") for j in range(0, len(raw), 32)]


@functools.lru_cache(maxsize=16)
def constant(value: int, device) -> torch.Tensor:
    """One element as a [16, 1] column, broadcast against [16, n]; made
    once a device and shared, never written: a copy to the card waits for
    the work queued before it, so a fresh copy in each product would keep
    the host from running ahead of the device."""
    return to_limbs([value], device)


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries (and borrows: the shift is arithmetic) upward in
    place; the top row keeps what is left over."""
    for i in range(t.shape[0] - 1):
        t[i + 1] += t[i] >> 16
        t[i] &= MASK
    return t


def _reduce_once(t: torch.Tensor) -> torch.Tensor:
    """[17, n] normalized limbs of a value below 2P -> [16, n] below P."""
    d = t.clone()
    d[:LIMBS] -= constant(P, t.device)
    _carry(d)
    return torch.where(d[LIMBS] < 0, t[:LIMBS], d[:LIMBS])


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = torch.zeros((LIMBS + 1,) + torch.broadcast_shapes(a.shape, b.shape)[1:],
                    dtype=torch.int64, device=a.device)
    t[:LIMBS] = a + b
    return _reduce_once(_carry(t))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = torch.zeros((LIMBS + 1,) + torch.broadcast_shapes(a.shape, b.shape)[1:],
                    dtype=torch.int64, device=a.device)
    t[:LIMBS] = a - b + constant(P, a.device)
    return _reduce_once(_carry(t))


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b / R mod P (CIOS-free: the whole product, then 16 reduction
    steps of one limb each)."""
    n = torch.broadcast_shapes(a.shape, b.shape)[1:]
    t = torch.zeros((2 * LIMBS + 1,) + n, dtype=torch.int64, device=a.device)
    for i in range(LIMBS):
        t[i:i + LIMBS].addcmul_(b, a[i:i + 1])
    p = constant(P, a.device)
    for i in range(LIMBS):
        m = ((t[i] & MASK) * N0) & MASK
        t[i:i + LIMBS].addcmul_(p, m[None])
        t[i + 1] += t[i] >> 16  # t[i] is now a multiple of 2^16
    return _reduce_once(_carry(t[LIMBS:]))


def to_mont(values: list[int], device) -> torch.Tensor:
    """Python ints -> their Montgomery forms as [16, n] limbs."""
    return to_limbs([v * R % P for v in values], device)


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, constant(1, a.device))


def batch_inverse(v: torch.Tensor) -> torch.Tensor:
    """Montgomery-form inverses of the [16, n] Montgomery-form elements
    of v, none of them zero: a product tree up (each level the products
    of its two halves, element i with element i + width / 2) until
    `HOST_LEVEL` elements are left, their inverses in Python ints, and the
    tree down (about 3n products, each level one pass over contiguous
    halves)."""
    n = v.shape[1]
    width = 1 << max(n - 1, 0).bit_length()
    one = torch.zeros((LIMBS, width - n), dtype=torch.int64, device=v.device)
    one[:] = constant(R % P, v.device)
    levels = [torch.cat([v, one], dim=1)]
    while levels[-1].shape[1] > HOST_LEVEL:
        lv, h = levels[-1], levels[-1].shape[1] // 2
        levels.append(mont_mul(lv[:, :h], lv[:, h:]))
    inv = to_limbs(_inverses_mont(from_limbs(levels.pop())), v.device)
    for lv in reversed(levels):
        h = lv.shape[1] // 2
        inv = torch.cat([mont_mul(inv, lv[:, h:]), mont_mul(inv, lv[:, :h])], dim=1)
    return inv[:, :n]


def _inverses_mont(xs: list[int]) -> list[int]:
    """(x R^-1)^-1 R = R^2 x^-1 mod P for each Montgomery form x, by one
    inverse and prefix products (Montgomery's trick) in Python ints."""
    prefix, acc = [], 1
    for x in xs:
        prefix.append(acc)
        acc = acc * x % P
    if acc == 0:
        raise ZeroDivisionError("batch_inverse: an element is zero")
    inv, out = R * R % P * pow(acc, -1, P) % P, [0] * len(xs)
    for i in reversed(range(len(xs))):
        out[i] = inv * prefix[i] % P
        inv = inv * xs[i] % P
    return out


def reduce_256(t: torch.Tensor) -> torch.Tensor:
    """[16, n] limbs of values below 2^256 -> the values mod P (four
    conditional subtractions of 8P, 4P, 2P and P: 2^256 < 16P)."""
    t = torch.cat([t, torch.zeros_like(t[:1])])
    for k in (3, 2, 1, 0):
        d = t.clone()
        d[:LIMBS] -= constant(P << k, t.device)
        _carry(d)
        t = torch.where(d[LIMBS] < 0, t, d)
    return t[:LIMBS]
