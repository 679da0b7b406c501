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
stage is a plain function that loops over this process's shards and
queues each shard's work on its device without waiting; only the combine
stage holds the collective.
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
# tensor on the first local device.
# ---------------------------------------------------------------------------


def _stage_accumulate(points, scalar_words: torch.Tensor, *, mesh: Mesh, window_size: int,
                      n_chunks: int, chunk_len: int, signed_digits: bool) -> list:
    """This process's shards -> their bucket sums [4, 16, K, B], each one
    batch of C * L points added into no carry (`accumulate_buckets` with
    n = C * L). `points`: [3, 16, n_local] Niels planes, or the shards'
    packed rows (`shard_rows`) as a fixed-base plan keeps them."""
    M = n_chunks * chunk_len
    rows = points if isinstance(points, (list, tuple)) else shard_rows(points, mesh, n_chunks, chunk_len)
    _check_count(scalar_words.shape[-1], mesh, M, "scalars")
    sums = []
    for i, (dev, r) in enumerate(zip(mesh.devices, rows)):
        with _on(dev):
            sw = limbs.as_i64(scalar_words[:, i * M : (i + 1) * M].to(dev, non_blocking=True))
            sums.append(pippenger.accumulate_rows(
                r, sw, window_size=window_size, n_chunks=n_chunks, chunk_len=chunk_len,
                signed_digits=signed_digits,
            ))
    return sums


def _reduce(bucket_sums: torch.Tensor) -> torch.Tensor:
    """[4, 16, K, B] bucket sums -> [4, 16, K] int32 Montgomery window sums
    on their device (`grouped_running_sum`, `reduce_finish`)."""
    with _on(bucket_sums.device):
        return pippenger.reduce_and_finish(bucket_sums)[1]


def _stage_reduce_local(bucket_sums: Sequence[torch.Tensor]) -> list:
    """Each local shard's buckets -> its window sums."""
    return [_reduce(b) for b in bucket_sums]


def _stage_gather_combine(local: Sequence[torch.Tensor], *, mesh: Mesh) -> torch.Tensor:
    """Every shard's partial sums [4, 16, *rest] -> their group sum, on the
    first local device: the local partials stacked there, gathered from
    every rank in rank order (the only collective), then tree-added."""
    dev = mesh.devices[0]
    with _on(dev):
        stacked = torch.stack([t.to(dev, non_blocking=True) for t in local])
        if mesh.group is not None:
            parts = [torch.empty_like(stacked) for _ in range(mesh.world_size)]
            dist.all_gather(parts, stacked, group=mesh.group)
            stacked = torch.cat(parts)
        return tree_add_points(stacked)


def sharded_stages(*, window_size: int, n_chunks: int, chunk_len: int, mesh: Mesh,
                   mode: str = "window_sums", signed_digits: bool = False) -> list:
    """The ordered (name, fn) stages of the sharded MSM. The first takes
    (points, scalar_words), each later one the output of the one before;
    exactly one, "combine", holds the collective, so a multi-process
    caller can meet its peers at a barrier just before it."""
    if mode not in MODES:
        raise ValueError(f"unknown collective mode {mode!r}; one of {MODES}")
    acc = functools.partial(
        _stage_accumulate, mesh=mesh, window_size=window_size, n_chunks=n_chunks,
        chunk_len=chunk_len, signed_digits=signed_digits,
    )
    combine = functools.partial(_stage_gather_combine, mesh=mesh)
    if mode == "buckets":
        # gather the raw bucket arrays, tree-add them, reduce once
        return [("accumulate", acc), ("combine", combine), ("reduce", _reduce)]
    return [("accumulate", acc), ("reduce", _stage_reduce_local), ("combine", combine)]


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
