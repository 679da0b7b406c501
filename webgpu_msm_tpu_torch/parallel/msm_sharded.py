"""Multi-GPU MSM: points sharded over a mesh of devices, partial sums
joined by group-law tree adds after one all-gather.

The counterpart of the JAX package's `parallel/msm_sharded.py`, over
`torch.distributed` (NCCL between cards, gloo between CPU processes) in
place of `jax.sharding` and `shard_map`. As there, the point vector is cut
into D shards of C * L points, each shard accumulates its own buckets, and
the partial sums meet in one collective.

Point addition is a group law of 9 products, not an integer sum, so an
`all_reduce` of digit planes would be wrong: the collective is an
`all_gather` of the int32 planes the kernels produce (256 B a point), then
a log-depth tree of adds (`tree_add_points`, one `padd_masked` launch a
level). Two payloads, the config's `collective_mode`:

- "window_sums": each shard reduces its own buckets; gather [4, 16, K] a
  shard. The default.
- "buckets": gather the raw bucket sums [4, 16, K, B] a shard, tree-add
  them, and run the bucket reduction once on the sum.

A `Mesh` is the devices this process drives, one shard each, and an
optional process group whose ranks drive as many shards each. A device may
repeat: D shards on one card make a virtual mesh (the counterpart of the
JAX tests' virtual CPU devices), whose shards time-share that card. Each
stage loops over this process's shards and queues each shard's work on
its device without waiting, as one stage-graph call on the card
(`utils/cache.py`, under the JAX export names); only the combine stage
holds the collective, which runs outside the graphs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..engines import gpu_engine
from ..ops import field_ops, limbs, pippenger
from ..utils import cache

AXIS = "points"  # the axis the point vector is sharded over (the JAX mesh axis name)
MODES = ("window_sums", "buckets")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards of one sharded MSM, as this process sees them.

    `devices`: the devices this process drives, one shard each, in shard
    order; a device may repeat (a virtual mesh). `group`: the process group
    of a multi-process run, or None for one process. Every process of the
    group drives the same number of devices, so process r holds the global
    shards r * len(devices) onwards (`offset`)."""

    devices: tuple
    group: Optional[object] = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """D, the number of shards over all processes."""
        return self.world_size * len(self.devices)

    @property
    def offset(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)


def default_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of this process alone (no process group).

    Without `device`: the first `n_devices` CUDA devices, every one by
    default; it raises without a card and when fewer than `n_devices`
    exist (the JAX one returns a smaller mesh). With `device` ("cpu",
    "cuda:0", ...): `n_devices` shards (1 by default) on that one device, a
    virtual mesh."""
    if device is not None:
        return Mesh((torch.device(device),) * (1 if n_devices is None else n_devices))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' for a virtual mesh on the CPU"
        )
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if not 1 <= n <= have:
        raise RuntimeError(f"a mesh of {n} devices asked for; this process sees {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def _on(dev: torch.device):
    """Make `dev` the current CUDA device while a shard's work is queued."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def tree_add_points(stacked: torch.Tensor) -> torch.Tensor:
    """[D, 4, 16, *batch] int32 stacked points -> [4, 16, *batch], their
    group sum.

    The JAX roll loop over the leading axis (level d = 1, 2, 4, ...: lane g
    becomes cur[g] + cur[g + d] where g + d < D), which is
    `pippenger._tree_sum_axis` over the axis moved last: one `padd_masked`
    launch a level, the JAX digits. D == 1 launches nothing."""
    if stacked.shape[0] == 1:
        return stacked[0]
    return pippenger._tree_sum_axis(stacked.movedim(0, -1))


def _check_count(n: int, mesh: Mesh, per_shard: int, what: str) -> None:
    want = len(mesh.devices) * per_shard
    if n != want:
        raise ValueError(
            f"{n} {what} for {len(mesh.devices)} local shards of {per_shard}: this process "
            f"must pass {want} (its host_local_slice of D * n_chunks * chunk_len)"
        )


def shard_rows(points: torch.Tensor, mesh: Mesh, n_chunks: int, chunk_len: int) -> list:
    """[3, 16, n_local] int32 Montgomery Niels planes -> each local shard's
    packed rows [C * L, 24] (`pippenger.pack_rows`) on its device."""
    M = n_chunks * chunk_len
    _check_count(points.shape[-1], mesh, M, "points")
    rows = []
    for i, dev in enumerate(mesh.devices):
        with _on(dev):
            rows.append(pippenger.pack_rows(points[..., i * M : (i + 1) * M].to(dev, non_blocking=True)))
    return rows


# ---------------------------------------------------------------------------
# The stages. window_sums: accumulate -> reduce -> combine; buckets:
# accumulate -> combine -> reduce (once). Between stages, a list of one
# int32 tensor a local shard, each on its device; after the combine, one
# tensor on the first local device. Each shard's work is one call of the
# stage graphs (`utils/cache.stage_call`) on its device, under the names of
# the JAX package's `_sharded_stage` exports; `dist.all_gather` runs outside
# every graph.
# ---------------------------------------------------------------------------


def _stat(static: dict) -> str:
    """The statics as the JAX `_sharded_stage` writes them into an export's
    name: "key" + value for each, sorted by key, joined by "_"."""
    return "_".join(f"{k}{v}" for k, v in sorted(static.items()))


def _shard_call(name: str, fn, *args) -> torch.Tensor:
    """One shard's stage on the device of its first argument, through the
    stage graphs. The shards of a virtual mesh share the key, and so one
    graph replayed a shard: each output is a clone (`clone=True`)."""
    with _on(args[0].device):
        return cache.stage_call(name, fn, *args)


def _accumulate_rows(rows, scalar_words, **static):
    """One shard's packed rows [C * L, 24] and words -> bucket sums [4, 16, K, B]."""
    return pippenger.accumulate_rows(rows, limbs.as_i64(scalar_words), **static)


def _stage_accumulate(points, scalar_words: torch.Tensor, *, mesh: Mesh, window_size: int,
                      n_chunks: int, chunk_len: int, signed_digits: bool) -> list:
    """This process's shards -> their bucket sums [4, 16, K, B], each one
    batch of C * L points added into no carry, one stage call
    `sharded_acc_D{D}_cuda_{stat}` a shard. `points`: [3, 16, n_local]
    Niels planes, or the shards' packed rows (`shard_rows`) as a fixed-base
    plan keeps them."""
    M = n_chunks * chunk_len
    rows = points if isinstance(points, (list, tuple)) else shard_rows(points, mesh, n_chunks, chunk_len)
    _check_count(scalar_words.shape[-1], mesh, M, "scalars")
    static = dict(window_size=window_size, n_chunks=n_chunks, chunk_len=chunk_len,
                  signed_digits=signed_digits)
    name = f"sharded_acc_D{mesh.size}_cuda_{_stat(static)}"
    fn = functools.partial(_accumulate_rows, **static)
    return [_shard_call(name, fn, r, scalar_words[:, i * M : (i + 1) * M].to(dev, non_blocking=True))
            for i, (dev, r) in enumerate(zip(mesh.devices, rows))]


def _window_sums(bucket_sums: torch.Tensor) -> torch.Tensor:
    """[4, 16, K, B] bucket sums -> [4, 16, K] int32 Montgomery window sums
    (`grouped_running_sum`, `reduce_finish`)."""
    return pippenger.reduce_and_finish(bucket_sums)[1]


def _stage_reduce_local(bucket_sums: Sequence[torch.Tensor], *, mesh: Mesh) -> list:
    """Each local shard's buckets -> its window sums, `sharded_reduce_D{D}`."""
    return [_shard_call(f"sharded_reduce_D{mesh.size}", _window_sums, b) for b in bucket_sums]


def _stage_reduce_rep(bucket_sums: torch.Tensor, *, mesh: Mesh) -> torch.Tensor:
    """buckets mode: the combined buckets -> window sums, once,
    `sharded_reduce_rep_D{D}`."""
    return _shard_call(f"sharded_reduce_rep_D{mesh.size}", _window_sums, bucket_sums)


def _combine(*parts: torch.Tensor) -> torch.Tensor:
    """Partial sums [n_i, 4, 16, *rest] in shard order -> their group sum."""
    return tree_add_points(torch.cat(parts))


def _prepare_after_gather(stacked: torch.Tensor, mesh: Mesh, mode: str) -> None:
    """Capture the graphs that run after the all-gather, on this rank's
    stacked partials [n_local, 4, 16, *rest] as stand-ins for every rank's:
    the combine's tree and, in buckets mode, the reduction of the combined
    buckets (the stage after the combine). A capture synchronizes the card,
    so a rank captures before it enters the all-gather, as the JAX package
    compiles every stage before the first collective."""
    if mesh.size > 1:
        cache.prepare(f"sharded_combine_D{mesh.size}", _combine, *[stacked] * mesh.world_size)
    if mode == "buckets":
        cache.prepare(f"sharded_reduce_rep_D{mesh.size}", _window_sums, stacked[0])


def _stage_gather_combine(local: Sequence[torch.Tensor], *, mesh: Mesh,
                          mode: str = "window_sums") -> torch.Tensor:
    """Every shard's partial sums [4, 16, *rest] -> their group sum, on the
    first local device: gathered from every rank in rank order (the only
    collective, outside the graphs, after the graphs that follow it are
    captured), then stacked and tree-added in the stage call
    `sharded_combine_D{D}` (at D 1 there is nothing to add)."""
    dev = mesh.devices[0]
    with _on(dev):
        local = [t.to(dev, non_blocking=True) for t in local]
        if mesh.group is None:
            parts = [t.unsqueeze(0) for t in local]
        else:
            stacked = torch.stack(local)
            _prepare_after_gather(stacked, mesh, mode)
            parts = [torch.empty_like(stacked) for _ in range(mesh.world_size)]
            dist.all_gather(parts, stacked, group=mesh.group)
        if mesh.size == 1:
            return parts[0][0]
        return cache.stage_call(f"sharded_combine_D{mesh.size}", _combine, *parts)


def sharded_stages(*, window_size: int, n_chunks: int, chunk_len: int, mesh: Mesh,
                   mode: str = "window_sums", signed_digits: bool = False) -> list:
    """The ordered (name, fn) stages of the sharded MSM. The first takes
    (points, scalar_words), each later one the output of the one before;
    exactly one, "combine", holds the collective, so a multi-process
    caller can meet its peers at a barrier just before it. Every graph of a
    rank is captured before it enters the collective: the stages before
    "combine" at their first call, the ones after it on stand-ins just
    before the all-gather (`_prepare_after_gather`)."""
    if mode not in MODES:
        raise ValueError(f"unknown collective mode {mode!r}; one of {MODES}")
    acc = functools.partial(
        _stage_accumulate, mesh=mesh, window_size=window_size, n_chunks=n_chunks,
        chunk_len=chunk_len, signed_digits=signed_digits,
    )
    combine = functools.partial(_stage_gather_combine, mesh=mesh, mode=mode)
    if mode == "buckets":
        # gather the raw bucket arrays, tree-add them, reduce once
        return [("accumulate", acc), ("combine", combine),
                ("reduce", functools.partial(_stage_reduce_rep, mesh=mesh))]
    return [("accumulate", acc), ("reduce", functools.partial(_stage_reduce_local, mesh=mesh)),
            ("combine", combine)]


def _run(stages: list, points, scalar_words: torch.Tensor) -> torch.Tensor:
    out = stages[0][1](points, scalar_words)
    for _, fn in stages[1:]:
        out = fn(out)
    return limbs.as_i64(out)


def msm_window_sums_sharded(
    points: torch.Tensor,  # [3, 16, n_local] int32 Montgomery Niels planes
    scalar_words: torch.Tensor,  # [8, n_local] LE u32 words (int32 bits or int64)
    *,
    window_size: int,
    n_chunks: int,  # per shard: D * n_chunks * chunk_len points in all
    chunk_len: int,
    mesh: Mesh,
    mode: str = "window_sums",
    signed_digits: bool = False,
) -> torch.Tensor:
    """Sharded MSM -> Montgomery window sums [4, 16, K] int64 (as
    `pippenger.msm_window_sums` returns them) on the first local device,
    the same on every process. Each process passes only its own points
    (`distributed.host_local_slice`): len(mesh.devices) * C * L of them.
    Nothing here waits for the device, but for the collective itself."""
    stages = sharded_stages(
        window_size=window_size, n_chunks=n_chunks, chunk_len=chunk_len, mesh=mesh,
        mode=mode, signed_digits=signed_digits,
    )
    return _run(stages, points, scalar_words)


class ShardedFixedBasePlan:
    """Fixed-base (SRS) plan over a mesh: the multi-GPU form of `MSMPlan`.

    The bases' packed rows are placed once, each shard's on its device, so
    a job launches neither `pack_rows` nor `to_niels` and streams only its
    [8, n] scalar words; jobs share the staged pipeline and its one
    collective.

        plan = ShardedFixedBasePlan(pts_niels, window_size=..., mesh=mesh)
        wsums = plan.window_sums(scalar_words)   # per job

    `signed_digits` is fixed at build time: callers check the scalar range
    as for `msm_window_sums_sharded`."""

    def __init__(self, points_niels: torch.Tensor, *, window_size: int, n_chunks: int,
                 chunk_len: int, mesh: Mesh, mode: str = "window_sums",
                 signed_digits: bool = False):
        self.mesh = mesh
        self.n_local = points_niels.shape[-1]
        self.n_global = mesh.size * n_chunks * chunk_len
        self._stages = sharded_stages(
            window_size=window_size, n_chunks=n_chunks, chunk_len=chunk_len, mesh=mesh,
            mode=mode, signed_digits=signed_digits,
        )
        self._rows = shard_rows(points_niels, mesh, n_chunks, chunk_len)

    def window_sums(self, scalar_words: torch.Tensor) -> torch.Tensor:
        """One job: this process's [8, n_local] LE scalar words -> Montgomery
        window sums [4, 16, K] int64, as `msm_window_sums_sharded`."""
        if scalar_words.shape[-1] != self.n_local:
            raise ValueError(
                f"plan holds {self.n_local} bases but got {scalar_words.shape[-1]} scalars"
            )
        return _run(self._stages, self._rows, scalar_words)


def window_sums_affine(wsums: torch.Tensor, window_size: int) -> tuple[int, int]:
    """Montgomery window sums [4, 16, K] (int64) -> the affine MSM result:
    `from_mont` where they lie, then the windows combined on the host."""
    plain = torch.stack([field_ops.from_mont(wsums[i]) for i in range(4)])
    return gpu_engine._fetch_affine(plain, window_size)
