"""Stage state between the JAX package and the port, as numpy uint32.

A JAX array fetched with `np.asarray` (Niels planes, a bucket carry,
window sums) becomes the port's tensor with the same bits, and back, so a
test can feed both packages the same state and compare them array for
array. The port keeps u32 bits in int32 tensors (torch's uint32 lacks
arithmetic) and computes in int64.
"""
from __future__ import annotations

import numpy as np
import torch


def planes_from_numpy(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy u32 planes -> int32 tensor holding the same bits on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def planes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of u32 bits, or int64 values in [0, 2^32) -> numpy u32."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.int32:
        return a.view(np.uint32)
    if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
        raise ValueError("values outside u32 range")
    return a.astype(np.uint32)


def mont_planes_from_points(points) -> np.ndarray:
    """Extended points (anything with x, y, t, z ints) -> [4, 16, n] uint32
    Montgomery digit planes."""
    from ..oracle import field

    out = np.zeros((4, 16, len(points)), dtype=np.uint32)
    for i, p in enumerate(points):
        for c, v in enumerate((p.x, p.y, p.t, p.z)):
            m = field.to_mont(v)
            out[c, :, i] = [(m >> (16 * d)) & 0xFFFF for d in range(16)]
    return out


def affine_from_planes(st, mont: bool = True) -> list[tuple[int, int]]:
    """[4, 16, n] digit planes of extended points (Montgomery domain unless
    `mont` is False) -> n affine (x, y): equality of points, whatever their
    extended form."""
    from ..oracle import curve, field

    st = np.asarray(st, dtype=np.uint64)
    scale = field.R_INV_MOD_P if mont else 1
    out = []
    for i in range(st.shape[-1]):
        vals = [sum(int(st[c, d, i]) << (16 * d) for d in range(16)) for c in range(4)]
        out.append(curve.to_affine(curve.ExtPoint(*(v * scale % field.P for v in vals))))
    return out


def wire_plan_from_jax_state(niels, *, n: int, w: int, C: int, L: int, pad_to: int,
                             config, device="cpu"):
    """The resident state of a JAX `WirePlan` (its `_niels` list fetched as
    numpy u32 [3, 16, C * L] arrays, and its `n`, `w`, `C`, `L`, `pad_to`)
    -> the port's `WirePlan` on `device`, so that bases built once in JAX
    serve scalar jobs in both packages."""
    from ..engines.gpu_engine import WirePlan

    return WirePlan.from_state(
        [planes_from_numpy(a, device) for a in niels],
        n=n, w=w, C=C, L=L, pad_to=pad_to, config=config, device=device,
    )
