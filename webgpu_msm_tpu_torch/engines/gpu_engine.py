"""GPU MSM engine: the counterpart of the JAX package's
`engines/tpu_engine.py`.

Every host-fed job enters by one representation, the one the API's check
or marshal gives it (`api._wire_inputs`, `api._job_rows`): contiguous
[n, 32] big-endian u32 point rows with z == 1 and [n, 8] scalar rows of
the same n. The engine trusts those rows and reads them for nothing but
the MSM. Two ways in, one host-to-device pipeline (`_stream_job`):

- the **wire path** (`msm_affine_wire`, `msm_affine_batch_wire`): the host
  writes x||y and the scalar rows once, padded, into one pinned buffer a
  job, a batch at a time, and queues each batch's copies and stage as
  soon as its rows are written; the `to_niels_xy_rows` kernel turns each
  batch's x||y rows into the scan's packed Niels rows;
- the **fixed-base plan** (`WirePlan`): the bases' packed Niels rows stay
  on the device and each job streams only its scalar rows.

`_device_msm` takes plain digit planes already on a device (the
device-resident entry; no API call reaches it).

Each batch stage adds its buckets into a device-resident bucket carry; one
finish stage reduces the carry to window sums (extended, or affine with
`device_affine`), and the host combines the windows. Copies and kernels are
queued on the current stream without waiting: the functions that return a
device tensor ("dispatch") do not synchronize, and the batch entry points
fetch results only after every job has been queued, each job's window sums
copied to the host right behind its own finish stage (`_HostCopy`), so
that the host combines one job while the device runs the next. Every
stage runs on `device`: the hand-written CUDA kernels on a GPU, their
plain PyTorch versions on the CPU.

Every stage goes through `_call_stage`, under the JAX engine's stage
names: on a GPU it is one replay of a CUDA graph, captured at the stage's
first call with its shapes (`utils/cache.py`), so a warm call queues a
few copies and replays rather than each stage's launches one by one. The
affine finish (`device_affine`) is one such stage too: the reduction's two
kernels, then the `finish_affine_divsteps` kernel for the z inverse.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..config import MSMConfig
from ..oracle import curve as ocurve
from ..oracle import field as ofield
from ..oracle.curve import ExtPoint
from ..oracle.msm import combine_windows
from ..ops import limbs, pippenger
from ..ops.kernels import padd_kernels as pk
from ..runtime import rows as row_copier
from ..utils import cache, convert, trace


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


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def _be_cols_to_planes(cols: torch.Tensor) -> torch.Tensor:
    """[n, 8] big-endian u32 rows (int64) -> [16, n] LE digit planes."""
    return limbs.from_words_le(cols.flip(1).t())


def _be_rows_to_words_le(rows_be: torch.Tensor) -> torch.Tensor:
    """[n, 8] BE u32 rows (int32 bits) -> [8, n] LE words (int64)."""
    return limbs.as_i64(rows_be).flip(1).t()


def _wire_niels(xy_be: torch.Tensor) -> torch.Tensor:
    """[M, 16] BE x||y rows (int32 bits) -> [3, 16, M] Montgomery Niels: the
    JAX `_wire_niels`. No path calls it: the wire path and the plan take
    the same rows to the scan's packed rows in one `to_niels_xy_rows`."""
    xy = limbs.as_i64(xy_be)
    planes = torch.stack([_be_cols_to_planes(xy[:, :8]), _be_cols_to_planes(xy[:, 8:])])
    return pk.to_niels_xy(planes.to(torch.int32))


def _identity_carry(window_size: int, signed_digits: bool, device) -> torch.Tensor:
    """[4, 16, K, B] int32 identity-point bucket carry."""
    return pippenger.identity_buckets(window_size, signed_digits, device)


def _batch_planes_impl(points_plain, scalar_words, carry_st, *, window_size, n_chunks,
                       chunk_len, signed_digits=False):
    """One planes batch: [3, 16, M] plain planes and [8, M] LE scalar words
    (int32 bits) -> carry [4, 16, K, B] + this batch's bucket sums."""
    return pippenger.accumulate_batch(
        pk.to_niels(points_plain), limbs.as_i64(scalar_words), window_size=window_size,
        n_chunks=n_chunks, chunk_len=chunk_len, signed_digits=signed_digits, carry=carry_st,
    )


def _fixed_batch_impl(pts_rows, scalars_be, carry_st, *, window_size, n_chunks,
                      chunk_len, signed_digits=False):
    """One fixed-base batch: resident packed Niels rows [M, 24] + this
    job's [M, 8] BE scalar rows."""
    return pippenger.accumulate_rows(
        pts_rows, _be_rows_to_words_le(scalars_be), window_size=window_size,
        n_chunks=n_chunks, chunk_len=chunk_len, signed_digits=signed_digits, carry=carry_st,
    )


def _wire_batch_impl(xy_be, scalars_be, carry_st, **static):
    """One wire batch of [M, 16] BE x||y rows: carry [4, 16, K, B] + this
    batch's bucket sums."""
    return _fixed_batch_impl(pk.to_niels_xy_rows(xy_be), scalars_be, carry_st, **static)


def _finish_impl(carry_st: torch.Tensor) -> torch.Tensor:
    """Bucket carry -> window sums [4, 16, K] int64, plain domain."""
    return limbs.as_i64(pippenger.reduce_and_finish(carry_st)[0])


def _finish_affine_impl(carry_st: torch.Tensor) -> torch.Tensor:
    """Bucket carry -> affine window sums [2, 16, K] int64, plain domain:
    the reduction's Montgomery window sums, then the z inverse (divsteps)
    and the products in the `finish_affine_divsteps` kernel."""
    return limbs.as_i64(pk.finish_affine_divsteps(pippenger.reduce_and_finish(carry_st)[1]))


def _call_finish(carry: torch.Tensor, window_size: int, signed: bool,
                 device_affine: bool) -> torch.Tensor:
    """The finish stage: `finish_affine_w{w}_s{s}` with `device_affine`,
    else `finish_w{w}_s{s}`, the JAX stage names."""
    impl, kind = (_finish_affine_impl, "finish_affine") if device_affine else (_finish_impl, "finish")
    return _call_stage(f"{kind}_w{window_size}_s{int(signed)}", impl, {}, carry)


def _call_stage(name: str, fn, static_kw: dict, *args, clone: bool = True):
    """Run one pipeline stage through the stage graphs (`utils/cache.py`):
    the JAX engine's `_call_stage`, its signature and its stage names.
    `name` must encode every static in `static_kw` (it keys the graphs).
    `clone=False` for a batch stage: its carry goes straight into the next
    stage call, which copies it before the graph is replayed again."""
    return cache.stage_call(name, functools.partial(fn, **static_kw), *args, clone=clone)


def _batch_name(kind: str, window_size: int, n_chunks: int, chunk_len: int, signed: bool) -> str:
    return f"{kind}_w{window_size}_c{n_chunks}x{chunk_len}_s{int(signed)}"


# ---------------------------------------------------------------------------
# Host <-> device
# ---------------------------------------------------------------------------


def _host_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A contiguous u32 array as an int32 host tensor, pinned for a GPU so
    that its copies to the device do not block the host."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32))
    return t.pin_memory() if device.type == "cuda" else t


def _staging(shape: tuple, device: torch.device) -> tuple[torch.Tensor, np.ndarray]:
    """An int32 host tensor to be filled, and its numpy u32 view. For a GPU
    it is pinned, from PyTorch's caching host allocator, which hands a
    block out again only after the copies queued from it have run: jobs
    queued before any fetch never share a buffer."""
    t = torch.empty(shape, dtype=torch.int32, pin_memory=device.type == "cuda")
    return t, t.numpy().view(np.uint32)


class _Staged:
    """A job's rows bound for the device, written batch by batch into one
    [pad_to, width] host tensor (`_staging`, allocated at the first
    write), so that a batch's copy can be queued while the next batch is
    written; the rows past the source's are `pad`. The source's first
    `width` words a row are written by the native row copier
    (`runtime/rows.py`), shared with its pool of workers from
    `rows.PARALLEL_ROWS` rows on."""

    def __init__(self, src: np.ndarray, pad_to: int, pad: Sequence[int], device: torch.device):
        self.src, self.pad_to, self.device = src, pad_to, device
        self.pad = np.array(pad, dtype=np.uint32)
        self.tensor = self.array = None

    def rows(self, lo: int, hi: int) -> torch.Tensor:
        """Write rows [lo, hi), padding where they pass the source's, and
        return them as a slice of the host tensor."""
        if self.tensor is None:
            self.tensor, self.array = _staging((self.pad_to, self.pad.shape[0]), self.device)
        a = self.array
        mid = min(max(self.src.shape[0], lo), hi)
        if row_copier.copy_rows(a[lo:mid], self.src[lo:mid]):
            trace.count(trace.PARALLEL_BATCHES, 1)
        a[mid:hi] = self.pad
        trace.count(trace.STAGED_BYTES, (hi - lo) * a.shape[1] * 4)
        return self.tensor[lo:hi]


def _stage_xy(rows: np.ndarray, pad_to: int, device: torch.device) -> _Staged:
    """The x||y words of [n, 32] wire rows, to be written into a
    [pad_to, 16] host tensor; the rows past n are the identity, x = 0 and
    y = 1 (the BE low word)."""
    return _Staged(rows, pad_to, [0] * 15 + [1], device)


def _stage_scalars(scalars_be: np.ndarray, pad_to: int, device: torch.device) -> _Staged:
    """[n, 8] BE scalar rows, to be written into a [pad_to, 8] host tensor,
    zero past n."""
    return _Staged(scalars_be, pad_to, [0] * 8, device)


def window_sums_to_points(wsums: np.ndarray) -> list[ExtPoint]:
    """Window-sum digit planes (plain domain) -> K ExtPoints. Takes both
    finish layouts: [4, 16, K] extended (x, y, t, z), and [2, 16, K] affine
    (x, y with z == 1; t = x*y is recomputed here, K bigint products)."""
    coords = []
    for c in range(wsums.shape[0]):
        words = (wsums[c, 0::2] | (wsums[c, 1::2] << 16)).astype(np.uint32)
        coords.append(convert.words_le_to_bigints(words))
    if len(coords) == 2:
        return [ExtPoint(x, y, x * y % ofield.P, 1) for x, y in zip(*coords)]
    return [ExtPoint(*xytz) for xytz in zip(*coords)]


class _HostCopy:
    """A job's window sums on their way to the host: their copy into pinned
    memory queued right behind the job's finish stage, and an event after
    it. `cpu()` waits for that event alone, where `Tensor.cpu()` would wait
    for everything queued on the stream since, the later jobs of a batch
    included."""

    def __init__(self, out: torch.Tensor):
        self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self.host.copy_(out, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(out.device))

    def cpu(self) -> torch.Tensor:
        self.done.synchronize()
        return self.host


def _queue_fetch(out: torch.Tensor, w: int):
    """(window sums, w) of a job queued in a batch: on a GPU its copy to
    the host is queued at once (`_HostCopy`), so that the job's fetch and
    host combine run while the device runs the jobs queued after it; on
    the CPU the sums as they are."""
    return (_HostCopy(out) if out.is_cuda else out), w


def _fetch_affine(out, w: int) -> tuple[int, int]:
    """Fetch one job's window sums (a device tensor or a `_HostCopy`; this
    waits for the device), combine the windows on the host and return the
    affine result."""
    with trace.span("fetch"):
        wsums = out.cpu().numpy()
    with trace.span("combine windows"):
        return ocurve.to_affine(combine_windows(window_sums_to_points(wsums), w))


def _padded_plan(config: MSMConfig, n: int) -> tuple[int, int, int, int]:
    """(w, C, L, pad_to) for n host-fed points: whole batches of C * L."""
    w, C, L = config.resolved_wire_plan(n)
    batch = C * L
    return w, C, L, -(-n // batch) * batch


# ---------------------------------------------------------------------------
# Host marshalling and the device-resident entry
# ---------------------------------------------------------------------------


def affine_xyt(points: Sequence[ExtPoint]) -> tuple[list[int], list[int], list[int]]:
    """Extended points -> their affine x, y and t = x*y below p; points
    with z != 1 are normalized here, on the host."""
    xs, ys, ts = [], [], []
    for p in points:
        if p.z != 1:
            zi = ofield.finv(p.z)
            x, y = p.x * zi % ofield.P, p.y * zi % ofield.P
            t = x * y % ofield.P
        else:
            x, y, t = p.x % ofield.P, p.y % ofield.P, p.t % ofield.P
        xs.append(x)
        ys.append(y)
        ts.append(t)
    return xs, ys, ts


def marshal_points(points: Sequence[ExtPoint], pad_to: int) -> np.ndarray:
    """Extended points -> [3, 16, pad_to] uint32 plain digit planes
    (x, y, t), padded with the identity (0, 1, 0)."""
    xs, ys, ts = affine_xyt(points)
    pad = pad_to - len(points)
    xs += [0] * pad
    ys += [1] * pad
    ts += [0] * pad
    words = np.stack([convert.bigints_to_words_le(v) for v in (xs, ys, ts)])  # [3, 8, pad_to]
    planes = np.empty((3, 16, pad_to), dtype=np.uint32)
    planes[:, 0::2] = words & 0xFFFF
    planes[:, 1::2] = words >> 16
    return planes


def marshal_scalars(scalars: Sequence[int], pad_to: int) -> np.ndarray:
    """Scalars -> [8, pad_to] uint32 LE word planes, padded with zeros."""
    return convert.bigints_to_words_le(list(scalars) + [0] * (pad_to - len(scalars)))


def _signed_ok(config: MSMConfig, scalar_words: np.ndarray) -> bool:
    """Signed recoding needs scalars < 2^254 (no carry out of the top
    window); field scalars are below 2^253 (LE word 7 < 2^29)."""
    return config.signed_digits and bool(np.all(scalar_words[7] < (1 << 29)))


def _device_msm(points_plain: torch.Tensor, scalar_words: torch.Tensor, *, window_size,
                n_chunks, chunk_len, signed_digits=False, device_affine=False) -> torch.Tensor:
    """Staged MSM over [3, 16, n] plain planes and [8, n] LE scalar words
    (int32 bits) already on a device, n a whole number of batches: each
    batch is sliced where the tensors lie (device-resident inputs, called
    with `config.resolved_window_size(n)` and `resolved_chunking(n)`: at
    2^20 one batch, which is the whole input and is not copied). Returns
    the finish stage's window sums on the device, without synchronizing."""
    M = n_chunks * chunk_len
    n = points_plain.shape[-1]
    assert n % M == 0, (n, M)
    static = dict(window_size=window_size, n_chunks=n_chunks, chunk_len=chunk_len,
                  signed_digits=signed_digits)
    bname = _batch_name("batch_planes", window_size, n_chunks, chunk_len, signed_digits)
    carry = _identity_carry(window_size, signed_digits, points_plain.device)
    trace.count(trace.BATCH_STAGES, n // M)
    for b in range(n // M):
        sl = slice(b * M, (b + 1) * M)
        carry = _call_stage(bname, _batch_planes_impl, static, points_plain[:, :, sl].contiguous(),
                            scalar_words[:, sl].contiguous(), carry, clone=False)
    return _call_finish(carry, window_size, signed_digits, device_affine)


# ---------------------------------------------------------------------------
# The wire path
# ---------------------------------------------------------------------------


# z == 1 as the last four u64 words of a row, from a view, so that it holds
# on any byte order.
_Z_ONE = np.array([0] * 7 + [1], dtype=np.uint32).view(np.uint64)
_Z_ONE_T = torch.from_numpy(_Z_ONE.view(np.int64))

# From this many rows on, the z test is one pass split over the host's
# CPUs; below it, numpy's pass on one core. A parallel pass waits for its
# slowest thread, and on a shared host a thread that loses its core for a
# time slice costs a few ms: on an H100's 8-CPU host a 2^16-row wire call's
# p95 rose from 11.1 to 13.6 ms with the parallel pass, and was even at
# 2^18 rows, where the serial pass takes 9 ms.
_Z_PARALLEL_ROWS = 1 << 18


def z_is_one(rows: np.ndarray) -> bool:
    """Whether every contiguous [n, 32] u32 row has z == 1 (the API's wire
    check, once a call or a shared array): one pass over z,
    read in place as four u64 words a row. From `_Z_PARALLEL_ROWS` rows on
    the pass is `torch.equal`'s, one parallel region over the host's CPUs
    with no intermediate; numpy's comparison of the same strided view runs
    an inner loop of four words a row on one core."""
    if rows.shape[0] < _Z_PARALLEL_ROWS:
        return bool((rows.view(np.uint64)[:, 12:] == _Z_ONE).all())
    z = torch.from_numpy(rows.view(np.int64))[:, 12:]
    return torch.equal(z, _Z_ONE_T.expand(z.shape))


def _signed_rows(scalars_be: np.ndarray) -> bool:
    """Whether signed digits apply to [n, 8] BE scalar rows: they need
    scalars < 2^254, and BE word 0 is the top word. Its `max` reads the
    words in place with no intermediate: on an H100's host, 0.5 ms for
    2^18 rows against 0.8 ms for `np.all` of the comparison."""
    return int(scalars_be[:, 0].max(initial=0)) < (1 << 29)


def _stream_job(kind: str, impl, span: str, write, sc: _Staged, *, window_size, n_chunks,
                chunk_len, signed_digits, device_affine, device: torch.device) -> torch.Tensor:
    """Write one job's rows and queue its stages batch by batch. Batch b's
    rows are written under `span` (`write(lo, hi)` writes rows [lo, hi) and
    returns the batch stage's arguments but the carry), then its stage call
    is queued under "queue stages": its copies from pinned memory are
    non-blocking, so the device copies and runs batch b while the host
    writes batch b + 1. The carry stays on the device. Returns the finish
    stage's window sums on the device, without synchronizing.

    With `signed_digits` each batch's scalar rows in `sc` are tested right
    after they are written (read from the source, which the copy has just
    brought into cache), and the batches are queued on signed digits until
    one fails: that batch is not queued, the remaining ones are written,
    and the whole job is queued again on unsigned digits from a fresh
    identity carry, the signed carry dropped. So no scalar at or above
    2^254 reaches a signed stage, and the result is the one the whole-job
    test gave."""
    M = n_chunks * chunk_len
    n_batches = sc.pad_to // M
    static = dict(window_size=window_size, n_chunks=n_chunks, chunk_len=chunk_len)

    def queue(args, carry, signed):
        trace.count(trace.BATCH_STAGES, 1)
        return _call_stage(_batch_name(kind, window_size, n_chunks, chunk_len, signed), impl,
                           dict(static, signed_digits=signed), *args, carry, clone=False)

    signed, requeue, written, carry = signed_digits, False, [], None
    for b in range(n_batches):
        lo, hi = b * M, (b + 1) * M
        with trace.span(span):
            written.append(write(lo, hi))
            if signed and not _signed_rows(sc.src[lo:hi]):
                signed, requeue = False, True
        if requeue:
            continue
        with trace.span("queue stages"):  # queued, not waited for
            if carry is None:
                carry = _identity_carry(window_size, signed, device)
            carry = queue(written[-1], carry, signed)
            if b + 1 < n_batches:
                trace.count(trace.BATCHES_STREAMED, 1)
            else:
                return _call_finish(carry, window_size, signed, device_affine)
    with trace.span("queue stages"):
        trace.count(trace.SIGNED_REQUEUES, int(requeue))
        carry = _identity_carry(window_size, signed, device)
        for args in written:
            carry = queue(args, carry, signed)
        return _call_finish(carry, window_size, signed, device_affine)


def _dispatch_wire(points_be: np.ndarray, scalars_be: np.ndarray, config: MSMConfig,
                   device: torch.device):
    """Write one job's wire rows into pinned memory and queue the device
    pipeline batch by batch (`_stream_job`); returns (window sums on the
    device, window size) without synchronizing, so a caller can queue many
    jobs before it fetches any. The rows are the API's, checked there."""
    n = points_be.shape[0]
    w, C, L, pad_to = _padded_plan(config, n)
    xy, sc = _stage_xy(points_be, pad_to, device), _stage_scalars(scalars_be, pad_to, device)
    out = _stream_job(
        "wire_batch", _wire_batch_impl, "slice/pad inputs (wire)",
        lambda lo, hi: (xy.rows(lo, hi), sc.rows(lo, hi)), sc, window_size=w, n_chunks=C,
        chunk_len=L, signed_digits=config.signed_digits, device_affine=config.device_affine,
        device=device,
    )
    return out, w


def msm_affine_wire(points_be: np.ndarray, scalars_be: np.ndarray, config: MSMConfig,
                    device: torch.device) -> tuple[int, int]:
    """Wire-format MSM: contiguous [n, 32] u32 BE point rows with z == 1
    and [n, 8] BE scalar rows of the same n, as the API gives them."""
    return _fetch_affine(*_dispatch_wire(points_be, scalars_be, config, device))


def msm_affine_batch_wire(jobs: Sequence[tuple[np.ndarray, np.ndarray]], config: MSMConfig,
                          device: torch.device) -> list[tuple[int, int]]:
    """Many wire MSMs (each job's rows as for `msm_affine_wire`): every
    job's copies and kernels, and the copy of its window sums to the host,
    are queued before any result is fetched."""
    queued = [_queue_fetch(*_dispatch_wire(points_be, scalars_be, config, device))
              for points_be, scalars_be in jobs]
    return [_fetch_affine(out, w) for out, w in queued]


# ---------------------------------------------------------------------------
# The fixed-base plan
# ---------------------------------------------------------------------------


class WirePlan:
    """Fixed bases resident on the device; each job streams its scalars.

    Construction copies the bases' x||y rows once and converts each batch
    to the scan's packed Montgomery Niels rows (`to_niels_xy_rows`), which
    stay on the device. A job then moves only its [n, 8] scalar rows, 32
    bytes a point against the wire path's 96, and runs no conversion and no
    packing. Batches keep the wire plan's (w, C, L). The bases are
    contiguous [n, 32] u32 BE rows with z == 1, and each job's scalars
    [n, 8] BE rows of the same n, as the API gives them.
    """

    def __init__(self, points_be: np.ndarray, config: MSMConfig, device: torch.device):
        self.config = config
        self.device = torch.device(device)
        self.n = points_be.shape[0]
        self.w, self.C, self.L, self.pad_to = _padded_plan(config, self.n)
        M = self.C * self.L
        with trace.span("build plan"):
            xy_t = _stage_xy(points_be, self.pad_to, self.device).rows(0, self.pad_to)
            # The batch on the device: a stage's device is that of its CUDA
            # tensors. Its rows [M, 24] stand for the JAX stage's Niels planes.
            self._rows = [
                _call_stage(f"plan_niels_m{M}", pk.to_niels_xy_rows, {},
                            xy_t[b * M : (b + 1) * M].to(self.device, non_blocking=True))
                for b in range(self.pad_to // M)
            ]

    @classmethod
    def from_state(cls, niels: Sequence[torch.Tensor], *, n: int, w: int, C: int, L: int,
                   pad_to: int, config: MSMConfig, device) -> "WirePlan":
        """A plan from resident state made elsewhere: one [3, 16, C * L]
        int32 Niels tensor per batch, packed here once into rows."""
        self = cls.__new__(cls)
        self.config, self.device = config, torch.device(device)
        self.n, self.w, self.C, self.L, self.pad_to = n, w, C, L, pad_to
        if len(niels) * C * L != pad_to or any(tuple(t.shape) != (3, 16, C * L) for t in niels):
            raise ValueError("resident Niels batches do not match (C, L, pad_to)")
        self._rows = [pippenger.pack_rows(t.to(self.device)) for t in niels]
        return self

    def dispatch(self, scalars_be: np.ndarray):
        """Queue one job's copies and kernels batch by batch as its scalar
        rows are written (`_stream_job`); returns (window sums on the
        device, w) without synchronizing."""
        M = self.C * self.L
        sc = _stage_scalars(scalars_be, self.pad_to, self.device)
        out = _stream_job(
            "fixed_batch", _fixed_batch_impl, "stage scalars (plan)",
            lambda lo, hi: (self._rows[lo // M], sc.rows(lo, hi)), sc, window_size=self.w,
            n_chunks=self.C, chunk_len=self.L, signed_digits=self.config.signed_digits,
            device_affine=self.config.device_affine, device=self.device,
        )
        return out, self.w

    def msm_affine(self, scalars_be: np.ndarray) -> tuple[int, int]:
        return _fetch_affine(*self.dispatch(scalars_be))

    def msm_affine_batch(self, scalars_list: Sequence[np.ndarray]) -> list[tuple[int, int]]:
        queued = [_queue_fetch(*self.dispatch(s)) for s in scalars_list]
        return [_fetch_affine(out, w) for out, w in queued]
