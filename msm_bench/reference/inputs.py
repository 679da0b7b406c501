"""The benchmark's inputs, made from the seed.

Points: the chain P_i = (k0 + i) * BASE for i < N, distinct subgroup
points with z = 1 and t = x * y whose discrete logs the benchmark knows.
They are made on the device in a few large calls: with N <= J * M,
P_{j M + l} = A_j + B_l, where A_j = (k0 + j M) * BASE and B_l = l * BASE
(J + M points in Python ints), then one affine addition for each row in
limb arithmetic, with the row's two denominators inverted together with
those of the other rows of its chunk. A point is a function of its index
alone, so the rows of any index come out the same whatever the chunks;
the device holds one chunk of at most `CHUNK_ROWS` rows at a time, and
each chunk goes straight to the host.

Scalars: 8 random u32 words reduced mod P (the reference harness's
draw: uniform below P up to a bias of P / 2^256), or, with `scalar_bits`
below 253, uniform below 2^scalar_bits; drawn `SCALAR_SLICE` scalars at a
time (one draw up to that many). On the host they are rows of 8 words, one
scalar after another, as the prize harnesses hand them over (a flat u32
array of n * 8 words).

An input set is the chain's rows in an order of its own (a permutation
drawn from the seed), or the fixed bases' one order, and scalars of its
own: nothing keyed on an array or its contents can stand in for the work.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import curve, field

MAX_POINTS = 1 << 26  # the largest chain: the prize's bases; `expected.py` sums indices below 2^27
CHUNK_ROWS = 1 << 21  # rows made on the device at a time: its scratch is bounded by this, not by N
SCALAR_SLICE = 1 << 20  # scalars drawn in one call; up to this many, one draw a set
SCALAR_GROUP = 8 * SCALAR_SLICE  # scalars reduced in one pass: fewer launches, a few GB of scratch


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


@dataclass
class _Chain:
    """A_j and B_l (module docstring) as Montgomery limbs on the device."""
    M: int
    a: tuple[torch.Tensor, torch.Tensor]  # x, y: [16, J]
    b: tuple[torch.Tensor, torch.Tensor]  # x, y: [16, M]

    @classmethod
    def make(cls, k0: int, n: int, device) -> "_Chain":
        if not 1 <= n <= MAX_POINTS:
            raise ValueError(f"a chain of 1 to 2^26 points, not {n}")
        M = 1 << math.ceil(math.log2(max(n, 2)) / 2)
        J = -(-n // M)
        A = _affine_chain(curve.scalar_mul(curve.BASE, k0), curve.scalar_mul(curve.BASE, M), J)
        B = _affine_chain(curve.IDENTITY, curve.BASE, M)
        coords = lambda pts: tuple(field.to_mont([p[c] for p in pts], device) for c in (0, 1))
        return cls(M, coords(A), coords(B))

    def rows(self, index: torch.Tensor) -> torch.Tensor:
        """The rows of P_i for the chain indices i in `index` (one chunk,
        on the chain's device), as [len(index), 32] int64 words (BE u32)."""
        j, l = index // self.M, index % self.M
        x1, y1 = (c[:, j] for c in self.a)
        x2, y2 = (c[:, l] for c in self.b)
        n = index.shape[0]
        device = index.device
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


class _HostBuffers:
    """The host arrays that the inputs are copied into, as int32 tensors,
    allocated at once. A thread writes zeros through each in turn, ahead of
    the copies: the first write to fresh host memory maps its pages and
    costs about as much as the copy itself, and the thread's writes overlap
    the device's work on the rows."""

    def __init__(self, shapes: list[tuple[int, ...]]):
        self._buffers = [torch.empty(shape, dtype=torch.int32) for shape in shapes]
        self._ready = [threading.Event() for _ in shapes]
        self._failed = None
        self._thread = threading.Thread(target=self._touch, name="inputs-touch")
        self._thread.start()

    def _touch(self) -> None:
        try:
            for buffer, ready in zip(self._buffers, self._ready):
                buffer.zero_()
                ready.set()
        except Exception as e:  # raised again by `take`
            self._failed = e
        finally:
            for ready in self._ready:
                ready.set()

    def take(self, i: int) -> torch.Tensor:
        """Buffer i, once the thread has written through it."""
        self._ready[i].wait()
        if self._failed is not None:
            raise self._failed
        return self._buffers[i]

    def close(self) -> None:
        self._thread.join()


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def rows_at(chain: _Chain, index: torch.Tensor, dst: torch.Tensor) -> np.ndarray:
    """The chain's rows at `index` (int64 on the chain's device), made
    `CHUNK_ROWS` at a time and copied into the [len(index), 32] int32 host
    tensor `dst`; returns its memory as u32."""
    for lo in range(0, index.shape[0], CHUNK_ROWS):
        dst[lo:lo + CHUNK_ROWS].copy_(chain.rows(index[lo:lo + CHUNK_ROWS]).to(torch.int32))
    return _u32(dst)


def chain_points(k0: int, n: int, device) -> np.ndarray:
    """The rows of P_i = (k0 + i) * BASE, i < n, as [n, 32] big-endian
    u32 words on the host, made on `device`."""
    device = torch.device(device)
    return rows_at(_Chain.make(k0, n, device), torch.arange(n, device=device),
                   torch.empty((n, 32), dtype=torch.int32))


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


def _scalar_words(limbs: torch.Tensor, scalar_bits: int) -> torch.Tensor:
    """[16, n] drawn limbs -> [8, n] int64: word j of each scalar in row j
    (BE u32)."""
    if scalar_bits >= 253:
        limbs = field.reduce_256(limbs)
    else:
        top, bit = divmod(scalar_bits, 16)
        limbs[top] &= (1 << bit) - 1
        limbs[top + 1:] = 0
    return (limbs[0::2] | (limbs[1::2] << 16)).flip(0)


def random_scalars(gen: torch.Generator, n: int, scalar_bits: int, device, dst: torch.Tensor) -> np.ndarray:
    """[n, 8] BE u32 words of scalars (see the module docstring) in the
    [n, 8] int32 host tensor `dst`, row after row; drawn `SCALAR_SLICE` at
    a time, reduced, laid out as rows on the device and copied
    `SCALAR_GROUP` at a time."""
    for lo in range(0, n, SCALAR_GROUP):
        hi = min(lo + SCALAR_GROUP, n)
        limbs = torch.cat([torch.randint(0, 1 << 16, (field.LIMBS, min(SCALAR_SLICE, hi - at)), generator=gen,
                                         device=device, dtype=torch.int64) for at in range(lo, hi, SCALAR_SLICE)], dim=1)
        dst[lo:hi].copy_(_scalar_words(limbs, scalar_bits).to(torch.int32).t().contiguous())
    return _u32(dst)


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
    chain = _Chain.make(k0, N, device)
    size = lambda s: sizes[s % len(sizes)]
    buffers = _HostBuffers([(size(0) if fixed_bases else N, 32)] + [(size(s), 8) for s in range(n_sets)])
    try:
        sets, shared, every_row = [], None, None
        for s in range(n_sets):
            n = size(s)
            if shared is None or not fixed_bases:
                perm = torch.randperm(N, generator=gen, device=device)[:n]
                index = perm.cpu()
                if fixed_bases:
                    points = rows_at(chain, perm, buffers.take(0))
                else:  # the whole chain once, and each set's order of it
                    if every_row is None:
                        every_row = buffers.take(0)
                        rows_at(chain, torch.arange(N, device=device), every_row)
                    points = _u32(every_row[index])
                shared = (points, index.numpy())
            scalars = random_scalars(gen, n, scalar_bits, device, buffers.take(1 + s))
            sets.append(InputSet(points=shared[0], scalars=scalars, chain_index=shared[1]))
    finally:
        buffers.close()
    return Inputs(k0=k0, sets=sets)
