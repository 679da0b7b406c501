"""GPU MSM engine for wire-format inputs: the counterpart of the JAX
package's `engines/tpu_engine.py` (its wire path).

The host validates and pads the [n, 32] / [n, 8] big-endian u32 rows and
copies each batch of x||y and scalar rows to the device, where one batch
stage (`_wire_batch_impl`: BE unpack, `to_niels_xy`, window split,
`_accumulate_batch`, carry add) adds its buckets into a device-resident
bucket carry. One finish stage reduces the carry to window sums, and the
host combines the windows. Every stage runs on `device`: the hand-written
CUDA kernels on a GPU, their plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import MSMConfig
from ..oracle import curve as ocurve
from ..oracle.curve import ExtPoint
from ..oracle.msm import combine_windows
from ..ops import field_ops, limbs, pippenger, windows
from ..ops.kernels import padd_kernels as pk
from ..utils import convert


def resolve_device(device=None) -> torch.device:
    """`device`, or the GPU when none is given. Without a GPU that is an
    error: the plain CPU path runs only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _be_cols_to_planes(cols: torch.Tensor) -> torch.Tensor:
    """[n, 8] big-endian u32 rows (int64) -> [16, n] LE digit planes."""
    return limbs.from_words_le(cols.flip(1).t())


def _wire_niels(xy_be: torch.Tensor) -> torch.Tensor:
    """[M, 16] BE x||y rows (int32 bits) -> [3, 16, M] Montgomery Niels."""
    xy = limbs.as_i64(xy_be)
    planes = torch.stack([_be_cols_to_planes(xy[:, :8]), _be_cols_to_planes(xy[:, 8:])])
    return pk.to_niels_xy(planes.to(torch.int32))


def _identity_carry(window_size: int, signed_digits: bool, device) -> torch.Tensor:
    """[4, 16, K, B] int32 identity-point bucket carry."""
    K = windows.n_windows(window_size)
    B = pippenger.n_buckets(window_size, signed_digits)
    return pippenger.identity_stacked((K, B), device)


def _wire_batch_impl(xy_be, scalars_be, carry_st, *, window_size, n_chunks,
                     chunk_len, signed_digits=False):
    """One wire batch: carry [4, 16, K, B] + this batch's bucket sums."""
    pts_niels = _wire_niels(xy_be)
    sw = limbs.as_i64(scalars_be).flip(1).t()  # [8, M] LE words
    digits = pippenger.compute_digits(sw, window_size, signed_digits)
    B = pippenger.n_buckets(window_size, signed_digits)
    bsums = pippenger._accumulate_batch(pts_niels, digits, window_size, n_chunks, chunk_len, B)
    shape = carry_st.shape
    return pk.padd(carry_st.reshape(4, 16, -1), bsums.reshape(4, 16, -1)).reshape(shape)


def _finish_impl(carry_st: torch.Tensor) -> torch.Tensor:
    """Bucket carry -> window sums [4, 16, K] int64, plain domain."""
    wsums = pippenger.reduce_buckets(carry_st)
    return torch.stack([field_ops.from_mont(wsums[i]) for i in range(4)])


def window_sums_to_points(wsums: np.ndarray) -> list[ExtPoint]:
    """[4, 16, K] window-sum digit planes (plain domain) -> K ExtPoints."""
    coords = []
    for c in range(4):
        words = (wsums[c, 0::2] | (wsums[c, 1::2] << 16)).astype(np.uint32)
        coords.append(convert.words_le_to_bigints(words))
    return [ExtPoint(*xyzt) for xyzt in zip(*coords)]


def _device_msm_wire_staged(xy: np.ndarray, sc: np.ndarray, *, window_size, n_chunks,
                            chunk_len, signed_digits, device: torch.device) -> torch.Tensor:
    """Staged wire MSM over padded [n, 16] x||y and [n, 8] scalar rows.

    Each batch's rows are copied with non_blocking=True from pinned host
    memory, so the host queues the copies and kernels of every batch
    without waiting; the carry stays on the device.
    """
    M = n_chunks * chunk_len
    n = xy.shape[0]
    assert n % M == 0, (n, M)
    xy_t = torch.from_numpy(xy.view(np.int32))
    sc_t = torch.from_numpy(sc.view(np.int32))
    if device.type == "cuda":
        xy_t, sc_t = xy_t.pin_memory(), sc_t.pin_memory()
    carry = _identity_carry(window_size, signed_digits, device)
    for b in range(n // M):
        dxy = xy_t[b * M : (b + 1) * M].to(device, non_blocking=True)
        dsc = sc_t[b * M : (b + 1) * M].to(device, non_blocking=True)
        carry = _wire_batch_impl(
            dxy, dsc, carry, window_size=window_size, n_chunks=n_chunks,
            chunk_len=chunk_len, signed_digits=signed_digits,
        )
    return _finish_impl(carry)


def _dispatch_wire(points_be: np.ndarray, scalars_be: np.ndarray, config: MSMConfig,
                   device: torch.device):
    """Validate and pad wire inputs, run the device pipeline; returns
    (window sums [4, 16, K] on the device, window size)."""
    points_be = np.ascontiguousarray(convert.as_u32_array(points_be, "wire points")).reshape(-1, 32)
    scalars_be = np.ascontiguousarray(convert.as_u32_array(scalars_be, "wire scalars")).reshape(-1, 8)
    n = points_be.shape[0]
    if scalars_be.shape[0] != n:
        raise ValueError(f"points/scalars length mismatch: {n} vs {scalars_be.shape[0]}")
    z = points_be[:, 24:32]
    if not (np.all(z[:, :7] == 0) and np.all(z[:, 7] == 1)):
        raise ValueError("the wire path requires z == 1")

    w, C, L = config.resolved_wire_plan(n)
    batch = C * L
    pad_to = -(-n // batch) * batch
    xy = np.zeros((pad_to, 16), dtype=np.uint32)
    xy[:n] = points_be[:, :16]
    xy[n:, 15] = 1  # identity padding: x = 0, y = 1 (BE low word)
    sc = np.zeros((pad_to, 8), dtype=np.uint32)
    sc[:n] = scalars_be
    # signed recoding needs scalars < 2^254; BE word 0 is the top word
    signed = config.signed_digits and bool(np.all(scalars_be[:, 0] < (1 << 29)))
    out = _device_msm_wire_staged(
        xy, sc, window_size=w, n_chunks=C, chunk_len=L, signed_digits=signed, device=device,
    )
    return out, w


def msm_affine_wire(points_be: np.ndarray, scalars_be: np.ndarray, config: MSMConfig,
                    device: torch.device) -> tuple[int, int]:
    """Wire-format MSM: [n, 32] BE point rows (z == 1), [n, 8] BE scalars."""
    out, w = _dispatch_wire(points_be, scalars_be, config, device)
    wsums = window_sums_to_points(out.cpu().numpy())
    return ocurve.to_affine(combine_windows(wsums, w))
