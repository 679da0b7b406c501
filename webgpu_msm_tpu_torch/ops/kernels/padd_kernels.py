"""Wrappers, plain versions and launch counts of the seven point kernels.

Each wrapper takes int32 tensors holding u32 bits, at the JAX package's
layouts (`ops/pallas/padd_kernels.py`). A tensor on the CPU goes to the
kernel's plain PyTorch version; a CUDA tensor launches the hand-written
sm_90a kernel of `csrc/*.cu` on the current stream, or raises.
No wrapper falls back from the kernel to the plain version.

`launches[name]` counts the kernel launches of each wrapper (never the
plain calls), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import torch

from .. import curve_ops, field_ops, limbs
from ..curve_ops import PointVec
from . import field_kernels_mma

KERNELS = (
    "to_niels_xy", "accumulate_scan", "padd_masked", "padd", "grouped_running_sum",
    "to_niels", "accumulate_scan_mma",
)
launches: dict[str, int] = {name: 0 for name in KERNELS}

SENTINEL = 0xFFFFFFFF  # initial scan id: no masked bucket id equals it


def reset_launch_counts() -> None:
    for name in KERNELS:
        launches[name] = 0


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """Validate tensors; True for CUDA (launch the kernel), False for CPU."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 tensors (u32 bits), got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.numel() >= 1 << 31:
            raise ValueError(f"{name}: tensor of {t.numel()} elements is too large")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _shape(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape) or min(shape) <= 0:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _launch(name: str, fn: str, *args) -> None:
    from . import build

    lib = build.load()
    rc = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: {lib.msm_error_string(rc).decode()}")
    launches[name] += 1


def _pts(st: torch.Tensor) -> PointVec:
    return PointVec.from_stacked(limbs.as_i64(st))


# ---------------------------------------------------------------------------
# 1. to_niels_xy: plain (x, y) [2, 16, M] -> Montgomery Niels [3, 16, M].
# ---------------------------------------------------------------------------
def to_niels_xy_plain(pts: torch.Tensor) -> torch.Tensor:
    p = limbs.as_i64(pts)
    return curve_ops.to_niels_from_xy(p[0], p[1]).to(torch.int32)


def to_niels_xy(pts: torch.Tensor) -> torch.Tensor:
    M = pts.shape[-1]
    _shape("to_niels_xy", pts, (2, 16, M))
    if not _on_card("to_niels_xy", pts):
        return to_niels_xy_plain(pts)
    out = torch.empty((3, 16, M), dtype=torch.int32, device=pts.device)
    _launch("to_niels_xy", "launch_to_niels_xy", pts.data_ptr(), out.data_ptr(), M)
    return out


# ---------------------------------------------------------------------------
# 6. to_niels: plain (x, y, t) [3, 16, W], values below p -> Montgomery
#    Niels (y-x, y+x, 2d*t) [3, 16, W].
# ---------------------------------------------------------------------------
def to_niels_plain(pts: torch.Tensor) -> torch.Tensor:
    return curve_ops.to_niels_planes(limbs.as_i64(pts)).to(torch.int32)


def to_niels(pts: torch.Tensor) -> torch.Tensor:
    W = pts.shape[-1]
    _shape("to_niels", pts, (3, 16, W))
    if not _on_card("to_niels", pts):
        return to_niels_plain(pts)
    out = torch.empty_like(pts)
    _launch("to_niels", "launch_to_niels", pts.data_ptr(), out.data_ptr(), W)
    return out


# ---------------------------------------------------------------------------
# 2 and 7. accumulate_scan: packed Niels [3, 8, L, W] + ids [L, W] ->
#    (final_acc [4, 16, W], final_id [W], staged [4, 16, L, W]), on CIOS
#    products or, with use_mma, on the matrix-form reduction (the tensor
#    cores on the card).
# ---------------------------------------------------------------------------
def accumulate_scan_plain(pts: torch.Tensor, ids: torch.Tensor, use_mma: bool = False):
    """Python loop over the L steps: the JAX package's lax.scan fallback.
    use_mma takes every product through `mont_mul_mma_plain`."""
    mul = field_kernels_mma.mont_mul_mma_plain if use_mma else field_ops.mont_mul
    _, _, L, W = pts.shape
    p = limbs.as_i64(pts)
    planes = torch.stack([p & limbs.DIGIT_MASK, p >> 16], dim=2).reshape(3, 16, L, W)
    raw = limbs.as_i64(ids)
    ident = curve_ops.identity((W,), pts.device)
    acc = ident
    acc_id = torch.full((W,), SENTINEL, dtype=torch.int64, device=pts.device)
    staged = torch.empty((4, 16, L, W), dtype=torch.int32, device=pts.device)
    for l in range(L):
        ids_l = raw[l] & 0x7FFFFFFF
        neg = (raw[l] >> 31) == 1
        ym0, yp0, td0 = planes[0, :, l], planes[1, :, l], planes[2, :, l]
        # Negation in Niels form: swap (y-x) <-> (y+x), negate 2d*t.
        ym = limbs.select(neg, yp0, ym0)
        yp = limbs.select(neg, ym0, yp0)
        td = limbs.select(neg, field_ops.field_neg(td0), td0)
        staged[:, :, l] = acc.stacked()
        # Run boundary: reset to the identity, then always add.
        acc = curve_ops.add_niels(
            curve_ops.select(ids_l == acc_id, acc, ident), ym, yp, td, mul=mul
        )
        acc_id = ids_l
    return acc.stacked().to(torch.int32), limbs.as_i32(acc_id), staged


def accumulate_scan(pts: torch.Tensor, ids: torch.Tensor, use_mma: bool = False):
    """use_mma (the JAX package's `use_mxu`) selects the kernel whose
    Montgomery reductions run on the tensor cores; the outputs are the same
    digit for digit. No engine sets it: the default is the CIOS scan."""
    _, _, L, W = pts.shape
    _shape("accumulate_scan", pts, (3, 8, L, W))
    _shape("accumulate_scan", ids, (L, W))
    if not _on_card("accumulate_scan", pts, ids):
        return accumulate_scan_plain(pts, ids, use_mma)
    dev = pts.device
    staged = torch.empty((4, 16, L, W), dtype=torch.int32, device=dev)
    final_acc = torch.empty((4, 16, W), dtype=torch.int32, device=dev)
    final_id = torch.empty((W,), dtype=torch.int32, device=dev)
    outs = (staged.data_ptr(), final_acc.data_ptr(), final_id.data_ptr(), L, W)
    if use_mma:
        m1, m2 = field_kernels_mma.const_inputs(dev)
        _launch(
            "accumulate_scan_mma", "launch_accumulate_scan_mma", pts.data_ptr(),
            ids.data_ptr(), m1.data_ptr(), m2.data_ptr(), *outs,
        )
    else:
        _launch("accumulate_scan", "launch_accumulate_scan", pts.data_ptr(), ids.data_ptr(), *outs)
    return final_acc, final_id, staged


# ---------------------------------------------------------------------------
# 3. padd_masked: mask ? a + b : a over [4, 16, W]; mask [W] (nonzero = add).
# ---------------------------------------------------------------------------
def padd_masked_plain(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    pa = _pts(a)
    return curve_ops.select(mask != 0, curve_ops.add(pa, _pts(b)), pa).stacked().to(torch.int32)


def padd_masked(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    W = a.shape[-1]
    for t, shape in ((a, (4, 16, W)), (b, (4, 16, W)), (mask, (W,))):
        _shape("padd_masked", t, shape)
    if not _on_card("padd_masked", a, b, mask):
        return padd_masked_plain(a, b, mask)
    out = torch.empty_like(a)
    _launch(
        "padd_masked", "launch_padd_masked", a.data_ptr(), b.data_ptr(), mask.data_ptr(),
        out.data_ptr(), W,
    )
    return out


# ---------------------------------------------------------------------------
# 4. padd: a + b over [4, 16, W] (unified hwcd-3 add).
# ---------------------------------------------------------------------------
def padd_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return curve_ops.add(_pts(a), _pts(b)).stacked().to(torch.int32)


def padd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    W = a.shape[-1]
    _shape("padd", a, (4, 16, W))
    _shape("padd", b, (4, 16, W))
    if not _on_card("padd", a, b):
        return padd_plain(a, b)
    out = torch.empty_like(a)
    _launch("padd", "launch_padd", a.data_ptr(), b.data_ptr(), out.data_ptr(), W)
    return out


# ---------------------------------------------------------------------------
# 5. grouped_running_sum: s [Gs, 4, 16, W] -> (T, U) [4, 16, W] with
#    T = sum_r s[r] and U = sum_r r * s[r].
# ---------------------------------------------------------------------------
def grouped_running_sum_plain(s: torch.Tensor):
    """r = Gs-1 .. 0: run += s[r]; U += run on every step but the last."""
    Gs, _, _, W = s.shape
    run = u = curve_ops.identity((W,), s.device)
    for i in range(Gs):
        run = curve_ops.add(run, _pts(s[Gs - 1 - i]))
        if i != Gs - 1:
            u = curve_ops.add(u, run)
    return run.stacked().to(torch.int32), u.stacked().to(torch.int32)


def grouped_running_sum(s: torch.Tensor):
    Gs, _, _, W = s.shape
    _shape("grouped_running_sum", s, (Gs, 4, 16, W))
    if not _on_card("grouped_running_sum", s):
        return grouped_running_sum_plain(s)
    T = torch.empty((4, 16, W), dtype=torch.int32, device=s.device)
    U = torch.empty_like(T)
    _launch(
        "grouped_running_sum", "launch_grouped_running_sum", s.data_ptr(), T.data_ptr(),
        U.data_ptr(), Gs, W,
    )
    return T, U
