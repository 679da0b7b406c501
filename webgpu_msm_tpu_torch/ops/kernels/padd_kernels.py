"""Wrappers, plain versions and launch counts of the fourteen kernels.

Each wrapper takes int32 tensors holding u32 bits, at the JAX package's
layouts (`ops/pallas/padd_kernels.py`). A tensor on the CPU goes to the
kernel's plain PyTorch version; a CUDA tensor launches the hand-written
sm_90a kernel of `csrc/*.cu` on the tensors' card and its current stream,
or raises. No wrapper falls back from the kernel to the plain version.

`launches[name]` counts the kernel launches of each wrapper (never the
plain calls), so a run can show that it went through the kernels. A
launch recorded into a CUDA graph runs only when the graph is replayed:
the stage-graph cache (`utils/cache.py`) takes a capture's launches back
out (`recorded_launches`) and adds them again at each replay
(`add_launches`), so the counts are those of an eager run;
`profiled_launches` reads a profile's kernel records, which can miss some
of a graph replay's (torch 2.11 and CUDA 12.8 on an H100, PERF.md).
"""
from __future__ import annotations

import contextlib

import torch

from .. import curve_ops, field_ops, limbs
from ..curve_ops import PointVec
from . import field_kernels_mma

KERNELS = (
    "to_niels_xy", "accumulate_scan", "padd_masked", "padd", "grouped_running_sum",
    "to_niels", "accumulate_scan_mma", "accumulate_scan_gather", "reduce_finish",
    "lane_scan", "assemble_buckets", "to_niels_xy_rows", "accumulate_scan_gather_mma",
    "finish_affine_divsteps",
)
launches: dict[str, int] = {name: 0 for name in KERNELS}

SENTINEL = 0xFFFFFFFF  # initial scan id: no masked bucket id equals it
CARD_THREADS = 132 * 256  # threads that about fill the card with the tree kernels
GROUP_THREADS = 256  # most threads a lane of grouped_running_sum
FINISH_LANES = 32  # most lanes a block of reduce_finish (two quads of four threads each)
FINISH_CLUSTER = 8  # most blocks a window of reduce_finish: a cluster, the portable maximum


def reset_launch_counts() -> None:
    for name in KERNELS:
        launches[name] = 0


@contextlib.contextmanager
def recorded_launches():
    """Yields a dict that, when the block ends, holds the launches made in
    it ({name: count}); those launches are taken back out of `launches`."""
    before = dict(launches)
    recorded: dict[str, int] = {}
    try:
        yield recorded
    finally:
        for name in KERNELS:
            if launches[name] != before[name]:
                recorded[name] = launches[name] - before[name]
                launches[name] = before[name]


def add_launches(counts: dict[str, int]) -> None:
    """Count the launches of one replay of a graph that recorded `counts`."""
    for name, n in counts.items():
        launches[name] += n


def profiled_launches(events) -> dict[str, int]:
    """{name: device runs of its kernel} among a `torch.profiler` profile's
    events (`prof.events()`), the kernels that graph replays run included:
    each wrapper's kernel is the symbol `<name>_kernel` (extern "C", so
    the profiler's name)."""
    from torch.autograd import DeviceType

    counts = dict.fromkeys(KERNELS, 0)
    for e in events:
        symbol = e.name.split("(")[0]
        if (e.device_type == DeviceType.CUDA and symbol.endswith("_kernel")
                and symbol[: -len("_kernel")] in counts):
            counts[symbol[: -len("_kernel")]] += 1
    return counts


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


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Launch `fn` on `device`, the card of the launch's tensors: under
    `torch.cuda.device(device)`, on that card's current stream, with its
    index passed on for the library to make current (the current device of
    the process may be another card)."""
    from . import build

    lib = build.load()
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(*args, device.index, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: {lib.msm_error_string(rc).decode()}")
    launches[name] += 1


def _pts(st: torch.Tensor) -> PointVec:
    return PointVec.from_stacked(limbs.as_i64(st))


def identity_planes(shape: tuple, device) -> torch.Tensor:
    """[4, 16, *shape] int32 identity points."""
    return curve_ops.identity(shape, device).stacked().to(torch.int32)


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
    _launch("to_niels_xy", "launch_to_niels_xy", pts.device, pts.data_ptr(), out.data_ptr(), M)
    return out


def pack_rows(niels: torch.Tensor) -> torch.Tensor:
    """[3, 16, M] Montgomery Niels digit planes -> [M, 24] int32 rows, the
    layout `accumulate_scan_gather` reads: y-x, y+x and 2d*t as 8 LE u32
    words each, word j = digit 2j | digit 2j+1 << 16."""
    p64 = limbs.as_i64(niels)
    packed = limbs.as_i32(p64[:, 0::2] | (p64[:, 1::2] << 16))  # [3, 8, M]
    return packed.reshape(24, -1).t().contiguous()


# ---------------------------------------------------------------------------
# 12. to_niels_xy_rows: the wire input stage, wire x||y rows [M, 16] (BE word
#    order: x in words 0-7, y in words 8-15, most significant first) ->
#    packed Montgomery Niels rows [M, 24] (`pack_rows`), in one launch.
# ---------------------------------------------------------------------------
def to_niels_xy_rows_plain(xy_be: torch.Tensor) -> torch.Tensor:
    """The chain the kernel replaces: the BE unpack of the JAX package's
    `_wire_niels`, `to_niels_xy_plain`, `pack_rows`."""
    xy = limbs.as_i64(xy_be)
    planes = torch.stack([limbs.from_words_le(xy[:, :8].flip(1).t()),
                          limbs.from_words_le(xy[:, 8:].flip(1).t())])
    return pack_rows(to_niels_xy_plain(planes.to(torch.int32)))


def to_niels_xy_rows(xy_be: torch.Tensor) -> torch.Tensor:
    M = xy_be.shape[0]
    _shape("to_niels_xy_rows", xy_be, (M, 16))
    if not _on_card("to_niels_xy_rows", xy_be):
        return to_niels_xy_rows_plain(xy_be)
    if xy_be.data_ptr() % 16:
        raise ValueError("to_niels_xy_rows: rows must start on a 16-byte boundary")
    out = torch.empty((M, 24), dtype=torch.int32, device=xy_be.device)
    _launch("to_niels_xy_rows", "launch_to_niels_xy_rows", xy_be.device, xy_be.data_ptr(),
            out.data_ptr(), M)
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
    _launch("to_niels", "launch_to_niels", pts.device, pts.data_ptr(), out.data_ptr(), W)
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
            "accumulate_scan_mma", "launch_accumulate_scan_mma", pts.device, pts.data_ptr(),
            ids.data_ptr(), m1.data_ptr(), m2.data_ptr(), *outs,
        )
    else:
        _launch("accumulate_scan", "launch_accumulate_scan", pts.device, pts.data_ptr(),
                ids.data_ptr(), *outs)
    return final_acc, final_id, staged


# ---------------------------------------------------------------------------
# 8 and 13. accumulate_scan_gather: the scan of every MSM path. Packed rows [M, 24]
#    (y-x, y+x, 2d*t limbs of each point), perm [L, W] (the row of lane w at
#    step l) and ids [L, W], with W = K * C lanes, window-major ->
#    (final_acc [4, 16, W], final_id [W], partial [4, 16, K * B]):
#    accumulate_scan's final_acc and final_id, and in place of `staged` the
#    in-lane partial sum of every bucket whose run ends inside a lane (the
#    identity elsewhere). Each window's ids must be sorted along its lanes'
#    steps (lane c of window k holds sorted positions c * L .. c * L + L - 1),
#    so that a bucket's run ends in at most one place. With use_mma every
#    product takes the matrix-form reduction (the tensor cores on the card).
# ---------------------------------------------------------------------------
def accumulate_scan_gather_plain(rows: torch.Tensor, perm: torch.Tensor, ids: torch.Tensor,
                                 n_windows: int, n_buckets: int, use_mma: bool = False):
    """The row gather, `accumulate_scan_plain` (with `use_mma`), and the
    select of the staged accumulators by the buckets' analytic end
    positions."""
    (L, W), K, B = ids.shape, n_windows, n_buckets
    C, dev = W // K, ids.device
    pts = rows[perm.reshape(-1).to(torch.int64)].t().reshape(3, 8, L, W).contiguous()
    final_acc, final_id, staged = accumulate_scan_plain(pts, ids, use_mma)
    sorted_ids = (limbs.as_i64(ids) & 0x7FFFFFFF).reshape(L, K, C).permute(1, 2, 0)
    k_idx = torch.arange(K, device=dev).reshape(K, 1)
    hist = torch.bincount((k_idx * B + sorted_ids.reshape(K, C * L)).reshape(-1), minlength=K * B)
    e_pos = torch.cumsum(hist.reshape(K, B), dim=1)  # first sorted index past bucket b
    # The accumulator before step e_pos holds bucket b's sum within that
    # lane, unless the bucket is empty or ends exactly at a lane edge.
    valid = (hist.reshape(K, B) > 0) & (e_pos % L != 0)
    at = (e_pos % L) * W + k_idx * C + torch.clamp(e_pos // L, max=C - 1)
    picked = staged.reshape(4, 16, L * W).index_select(2, at.reshape(-1))
    partial = torch.where(valid.reshape(-1), picked, identity_planes((K * B,), dev))
    return final_acc, final_id, partial


def accumulate_scan_gather(rows: torch.Tensor, perm: torch.Tensor, ids: torch.Tensor,
                           n_windows: int, n_buckets: int, use_mma: bool = False):
    """use_mma selects `accumulate_scan_gather_mma`, the same scan with its
    Montgomery reductions on the tensor cores; the outputs are the same
    digit for digit. No path sets it: every path runs the CIOS scan."""
    (L, W), M = ids.shape, rows.shape[0]
    _shape("accumulate_scan_gather", rows, (M, 24))
    _shape("accumulate_scan_gather", perm, (L, W))
    if W % n_windows or n_buckets <= 0:
        raise ValueError(f"accumulate_scan_gather: {W} lanes do not split into {n_windows} windows")
    if not _on_card("accumulate_scan_gather", rows, perm, ids):
        return accumulate_scan_gather_plain(rows, perm, ids, n_windows, n_buckets, use_mma)
    dev = rows.device
    partial = identity_planes((n_windows * n_buckets,), dev)
    final_acc = torch.empty((4, 16, W), dtype=torch.int32, device=dev)
    final_id = torch.empty((W,), dtype=torch.int32, device=dev)
    outs = (partial.data_ptr(), final_acc.data_ptr(), final_id.data_ptr(), L, W, W // n_windows,
            n_buckets)
    ins = (rows.data_ptr(), perm.data_ptr(), ids.data_ptr())
    if use_mma:
        m1, m2 = field_kernels_mma.const_inputs(dev)
        _launch("accumulate_scan_gather_mma", "launch_accumulate_scan_gather_mma", dev, *ins,
                m1.data_ptr(), m2.data_ptr(), *outs)
    else:
        _launch("accumulate_scan_gather", "launch_accumulate_scan_gather", dev, *ins, *outs)
    return final_acc, final_id, partial


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
        "padd_masked", "launch_padd_masked", a.device, a.data_ptr(), b.data_ptr(),
        mask.data_ptr(), out.data_ptr(), W,
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
    _launch("padd", "launch_padd", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), W)
    return out


# ---------------------------------------------------------------------------
# 10. lane_scan: the segmented inclusive scan over the C lanes of each window
#    of final_acc [4, 16, K * C] with final_id [K * C]: for d = 1, 2, 4, ...
#    < C, lane c becomes v[c] + v[c - d] where c >= d and the ids of lanes c
#    and c - d are equal (c is the lane inside its window). At the last lane
#    of each equal-id segment: the segment's total.
# ---------------------------------------------------------------------------
def lane_scan_plain(final_acc: torch.Tensor, final_id: torch.Tensor, n_windows: int) -> torch.Tensor:
    """The JAX package's seg_level loop: one `padd_masked_plain` a level."""
    W = final_acc.shape[-1]
    K, C = n_windows, W // n_windows
    lane = torch.arange(C, device=final_acc.device)
    ids = final_id.reshape(K, C)
    carries = final_acc.reshape(4, 16, K, C)
    for i in range(max((C - 1).bit_length(), 1)):
        d = 1 << i
        shifted = torch.roll(carries, d, dims=-1)
        ok = (lane >= d) & (torch.roll(ids, d, dims=-1) == ids)
        carries = padd_masked_plain(
            carries.reshape(4, 16, W), shifted.reshape(4, 16, W), ok.reshape(W).to(torch.int32),
        ).reshape(4, 16, K, C)
    return carries.reshape(4, 16, W)


def lane_scan(final_acc: torch.Tensor, final_id: torch.Tensor, n_windows: int) -> torch.Tensor:
    W = final_acc.shape[-1]
    _shape("lane_scan", final_acc, (4, 16, W))
    _shape("lane_scan", final_id, (W,))
    if n_windows <= 0 or W % n_windows:
        raise ValueError(f"lane_scan: {W} lanes do not split into {n_windows} windows")
    if not _on_card("lane_scan", final_acc, final_id):
        return lane_scan_plain(final_acc, final_id, n_windows)
    out = torch.empty_like(final_acc)
    scratch = torch.empty_like(final_acc)
    _launch(
        "lane_scan", "launch_lane_scan", final_acc.device, final_acc.data_ptr(),
        final_id.data_ptr(), out.data_ptr(), scratch.data_ptr(), n_windows, W // n_windows,
    )
    return out


# ---------------------------------------------------------------------------
# 11. assemble_buckets: bucket b of window k (hist [K, B] points, e_pos [K, B]
#    the first sorted index past them) is partial + the lane scan's total of
#    the lanes its run covers up to a lane edge (lane c_last = e_pos // L - 1
#    of carries [4, 16, K * C], where c_last >= s_pos // L; the identity
#    elsewhere); with a carry [4, 16, K * B], carry + that sum. The JAX
#    order of adds, identities included.
# ---------------------------------------------------------------------------
def assemble_buckets_plain(partial: torch.Tensor, carries: torch.Tensor, hist: torch.Tensor,
                           e_pos: torch.Tensor, chunk_len: int, carry: torch.Tensor | None = None):
    """The index_select, where and `padd_plain` of the bucket assembly, and
    a second `padd_plain` for the carry."""
    (K, B), dev = hist.shape, hist.device
    C, L = carries.shape[-1] // K, chunk_len
    e_pos = e_pos.to(torch.int64)
    s_pos = e_pos - hist.to(torch.int64)
    c_last = e_pos // L - 1
    carry_valid = c_last >= s_pos // L
    k_idx = torch.arange(K, device=dev).reshape(K, 1)
    carry_idx = (k_idx * C + torch.clamp(c_last, 0, C - 1)).reshape(-1)
    picked = carries.index_select(2, carry_idx)
    bsum = padd_plain(partial, torch.where(carry_valid.reshape(-1), picked, identity_planes((K * B,), dev)))
    return bsum if carry is None else padd_plain(carry, bsum)


def assemble_buckets(partial: torch.Tensor, carries: torch.Tensor, hist: torch.Tensor,
                     e_pos: torch.Tensor, chunk_len: int, carry: torch.Tensor | None = None):
    """[4, 16, K * B] bucket sums of one batch, added to `carry` if given.
    `carry` is read, never written: the result is a new tensor."""
    K, B = hist.shape
    W = carries.shape[-1]
    tensors = (partial, carries, hist, e_pos) + (() if carry is None else (carry,))
    for t, shape in zip(tensors, ((4, 16, K * B), (4, 16, W), (K, B), (K, B), (4, 16, K * B))):
        _shape("assemble_buckets", t, shape)
    if W % K or chunk_len <= 0:
        raise ValueError(f"assemble_buckets: {W} lanes do not split into {K} windows")
    if not _on_card("assemble_buckets", *tensors):
        return assemble_buckets_plain(partial, carries, hist, e_pos, chunk_len, carry)
    out = torch.empty_like(partial)
    _launch(
        "assemble_buckets", "launch_assemble_buckets", partial.device, partial.data_ptr(),
        carries.data_ptr(), hist.data_ptr(), e_pos.data_ptr(),
        None if carry is None else carry.data_ptr(),
        out.data_ptr(), K, B, W // K, chunk_len,
    )
    return out


# ---------------------------------------------------------------------------
# 5 and 9. The bucket reduction after the bucket sums: grouped_running_sum
#    and reduce_finish. Extended coordinates are not canonical: the same
#    point has many digit forms, and the order of the adds picks one.
#    `_tree_sums` adds in the order of `tree_sums` (csrc/padd_kernels.cu) and
#    `_fold_sums` in that of `reduce_finish_kernel`, so kernel and plain
#    version agree digit for digit; against a serial chain of adds they agree
#    as points.
# ---------------------------------------------------------------------------
def _group_plan(n: int, lanes: int, max_threads: int) -> tuple[int, int]:
    """(P, q): P threads share a lane of n elements, q = ceil(n / P) each.
    P is a power of two, at most next_pow2(n) and `max_threads`, and small
    enough that lanes * P threads do not overfill the card."""
    fill = max(1, CARD_THREADS // lanes)
    P = min(max_threads, 1 << (n - 1).bit_length(), 1 << (fill.bit_length() - 1))
    return P, -(-n // P)


def _add_st(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unified add over stacked [4, 16, ...] int64 points."""
    return curve_ops.add(PointVec.from_stacked(a), PointVec.from_stacked(b)).stacked()


def _tree_sums(s: torch.Tensor, P: int):
    """s [n, 4, 16, W] -> (T, U) [4, 16, W] int64 with T = sum_r s[r] and
    U = sum_r r * s[r], adding in the order of P threads a lane: chunk sums
    of q = ceil(n / P) elements (padded with the identity), an inclusive
    suffix scan of them, U's terms run_r (r >= 1) summed per chunk, and a
    tree fold of those. Axis 2 of the stacked tensors below is the thread."""
    n, _, _, W = s.shape
    q, dev = -(-n // P), s.device
    ident = lambda count: curve_ops.identity((count, W), dev).stacked()
    e = torch.cat([limbs.as_i64(s).permute(1, 2, 0, 3), ident(P * q - n)], dim=2)
    e = e.reshape(4, 16, P, q, W)
    incl = e[:, :, :, q - 1]
    for j in range(q - 2, -1, -1):
        incl = _add_st(e[:, :, :, j], incl)
    d = 1
    while d < P:
        incl = torch.cat([_add_st(incl[:, :, : P - d], incl[:, :, d:]), incl[:, :, P - d :]], dim=2)
        d *= 2
    if q == 1:
        v = torch.cat([ident(1), incl[:, :, 1:]], dim=2)
    else:
        run = torch.cat([incl[:, :, 1:], ident(1)], dim=2)
        for j in range(q - 1, -1, -1):
            run = _add_st(run, e[:, :, :, j])
            if j == q - 1:
                v = run
            elif j > 0:
                v = _add_st(v, run)
            else:  # element 0 of the lane has weight 0: thread 0 skips it
                v = torch.cat([v[:, :, :1], _add_st(v[:, :, 1:], run[:, :, 1:])], dim=2)
    h = P // 2
    while h >= 1:
        v = _add_st(v[:, :, :h], v[:, :, h : 2 * h])
        h //= 2
    return incl[:, :, 0], v[:, :, 0]


def grouped_running_sum_plain(s: torch.Tensor):
    Gs, _, _, W = s.shape
    T, U = _tree_sums(s, _group_plan(Gs, W, GROUP_THREADS)[0])
    return T.to(torch.int32), U.to(torch.int32)


def grouped_running_sum(s: torch.Tensor):
    """s [Gs, 4, 16, W] -> (T, U) [4, 16, W], with `_group_plan`'s threads
    a lane."""
    Gs, _, _, W = s.shape
    _shape("grouped_running_sum", s, (Gs, 4, 16, W))
    if not _on_card("grouped_running_sum", s):
        return grouped_running_sum_plain(s)
    T = torch.empty((4, 16, W), dtype=torch.int32, device=s.device)
    U = torch.empty_like(T)
    _launch(
        "grouped_running_sum", "launch_grouped_running_sum", s.device, s.data_ptr(), T.data_ptr(),
        U.data_ptr(), Gs, W, _group_plan(Gs, W, GROUP_THREADS)[0],
    )
    return T, U


def _finish_plan(G: int) -> tuple[int, int]:
    """(M, NL): `reduce_finish` reduces a window of G groups on a cluster of
    M blocks of NL lanes (a lane is two quads of four threads: 8 NL threads
    a block), N = M * NL lanes, the largest power of two at most G and
    FINISH_CLUSTER * FINISH_LANES."""
    N = min(1 << (G.bit_length() - 1), FINISH_CLUSTER * FINISH_LANES)
    NL = min(N, FINISH_LANES)
    return N // NL, NL


def _skip_add(a: torch.Tensor, a_empty: torch.Tensor, b: torch.Tensor, b_empty: torch.Tensor):
    """The kernel's add with empty operands (the identity, never added):
    a + b where both are points, else the one that is not empty. Points
    [4, 16, K, E] int64, masks [K, E] bool; returns (sum, mask)."""
    return torch.where(a_empty, b, torch.where(b_empty, a, _add_st(a, b))), a_empty & b_empty


def _fold_sums(T: torch.Tensor, U: torch.Tensor, n_windows: int, N: int):
    """(sum_g g * T_g, sum_g U_g) of each window of T, U [4, 16, K * G], as
    ([4, 16, K] int64, [K] empty mask) each, adding in the order of
    `reduce_finish_kernel` with N lanes a window: lane n walks the groups
    g = i * N + n from the top i down (s = sum T_g, r += run where i >= 1,
    u = sum U_g), then log2 N levels fold pairs (2p, 2p + 1) of the sums
    rho, sigma, tau, ups (rho' = (rho + rho') + sigma', sigma' = 2 (sigma +
    sigma'), tau' = 2 (tau + tau'), ups' = ups + ups'; 2x is x + x), from
    rho empty, sigma = s, tau = r, ups = u; sum_g g * T_g = rho + tau."""
    K, G = n_windows, T.shape[-1] // n_windows
    I, dev = -(-G // N), T.device
    pad = curve_ops.identity((K, I * N - G), dev).stacked()
    lanes = lambda x: torch.cat([limbs.as_i64(x).reshape(4, 16, K, G), pad], dim=-1).reshape(4, 16, K, I, N)
    t, u = lanes(T), lanes(U)
    skip = (torch.arange(I * N, device=dev) >= G).reshape(I, 1, N).expand(I, K, N)
    empty = torch.ones((K, N), dtype=torch.bool, device=dev)
    run = r = us = curve_ops.identity((K, N), dev).stacked()
    run_e = r_e = us_e = empty
    for i in range(I - 1, -1, -1):
        run, run_e = _skip_add(run, run_e, t[:, :, :, i], skip[i])
        if i >= 1:
            r, r_e = _skip_add(r, r_e, run, run_e | skip[i])
        us, us_e = _skip_add(us, us_e, u[:, :, :, i], skip[i])
    rho, sigma, tau, ups = (run, empty), (run, run_e), (r, r_e), (us, us_e)
    lo = lambda s: (s[0][..., 0::2], s[1][:, 0::2])
    hi = lambda s: (s[0][..., 1::2], s[1][:, 1::2])
    dbl = lambda s: _skip_add(*s, *s)
    while sigma[0].shape[-1] > 1:
        rho = _skip_add(*_skip_add(*lo(rho), *hi(rho)), *hi(sigma))
        sigma, tau, ups = (dbl(_skip_add(*lo(sigma), *hi(sigma))), dbl(_skip_add(*lo(tau), *hi(tau))),
                           _skip_add(*lo(ups), *hi(ups)))
    weighted, w_empty = _skip_add(*rho, *tau)
    return (weighted[..., 0], w_empty[:, 0]), (ups[0][..., 0], ups[1][:, 0])


def reduce_finish_plain(T: torch.Tensor, U: torch.Tensor, n_windows: int, doublings: int):
    M, NL = _finish_plan(T.shape[-1] // n_windows)
    (weighted, w_empty), (total, _) = _fold_sums(T, U, n_windows, M * NL)
    v = PointVec.from_stacked(weighted)
    for _ in range(doublings):
        v = curve_ops.double(v)
    mont = torch.where(w_empty, total, curve_ops.add(v, PointVec.from_stacked(total)).stacked())
    plain = torch.stack([field_ops.from_mont(mont[i]) for i in range(4)])
    return plain.to(torch.int32), mont.to(torch.int32)


def reduce_finish(T: torch.Tensor, U: torch.Tensor, n_windows: int, doublings: int):
    """The end of the bucket reduction. T, U [4, 16, K * G]: the first
    grouped pass's sums of group g of window k at lane k * G + g. Returns the
    window sums 2^doublings * sum_g g * T_g + sum_g U_g as [4, 16, K] planes,
    (plain domain, Montgomery domain)."""
    K, W = n_windows, T.shape[-1]
    _shape("reduce_finish", T, (4, 16, W))
    _shape("reduce_finish", U, (4, 16, W))
    if K <= 0 or W % K or doublings < 0:
        raise ValueError(f"reduce_finish: {W} lanes do not split into {K} windows")
    if not _on_card("reduce_finish", T, U):
        return reduce_finish_plain(T, U, K, doublings)
    plain = torch.empty((4, 16, K), dtype=torch.int32, device=T.device)
    mont = torch.empty_like(plain)
    _launch(
        "reduce_finish", "launch_reduce_finish", T.device, T.data_ptr(), U.data_ptr(),
        plain.data_ptr(), mont.data_ptr(), W // K, K, *_finish_plan(W // K), doublings,
    )
    return plain, mont


# ---------------------------------------------------------------------------
# 14. finish_affine_divsteps: Montgomery window sums [4, 16, K] (as
#    `reduce_finish` writes its `mont` output) -> plain affine (x, y)
#    [2, 16, K]: the XLA tail of the JAX package's `_finish_affine_impl`,
#    z = 0 mapped to 0, with the z inverse by divsteps (safegcd) in the
#    kernel; the one the `device_affine` finish launches. Its plain version
#    is `finish_affine_plain`.
# ---------------------------------------------------------------------------
def finish_affine_plain(mont: torch.Tensor) -> torch.Tensor:
    """`field_ops.finv_mont` of z, two products and `from_mont`."""
    m = limbs.as_i64(mont)
    zi = field_ops.finv_mont(m[3])
    return torch.stack([field_ops.from_mont(field_ops.mont_mul(m[c], zi)) for c in (0, 1)]).to(torch.int32)


def finish_affine_divsteps(mont: torch.Tensor) -> torch.Tensor:
    K = mont.shape[-1]
    _shape("finish_affine_divsteps", mont, (4, 16, K))
    if not _on_card("finish_affine_divsteps", mont):
        return finish_affine_plain(mont)
    out = torch.empty((2, 16, K), dtype=torch.int32, device=mont.device)
    _launch("finish_affine_divsteps", "launch_finish_affine_divsteps", mont.device, mont.data_ptr(),
            out.data_ptr(), K)
    return out
