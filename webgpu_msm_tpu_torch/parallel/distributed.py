"""Multi-process runtime: `torch.distributed` init and the global mesh.

The counterpart of the JAX package's `parallel/distributed.py`: one
process per card (or per host on the CPU), `init` as the layer that joins
the processes, and a global mesh whose one collective, the all-gather of
`msm_sharded.py`, runs over NCCL between cards (NVLink within a host) or
gloo between CPU processes.

Usage, one process per card (under torchrun, or with explicit arguments):

    from webgpu_msm_tpu_torch.parallel import distributed
    distributed.init()                      # MASTER_ADDR / WORLD_SIZE / RANK
    mesh = distributed.global_mesh()
    sl = distributed.host_local_slice(n_global)
    wsums = msm_window_sums_sharded(points[..., sl], words[:, sl], ..., mesh=mesh)

Each process feeds only its own slice of the point vector.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .msm_sharded import Mesh

_INITIALIZED = False
_DEVICE: Optional[torch.device] = None  # this process's device, set by `init`

# torchrun's variables: a multi-process launch is configured when the
# coordinator's address is (the counterpart of the JAX coordinator variables).
_COORDINATOR_ENV = ("MASTER_ADDR",)


def _process_device(device) -> torch.device:
    """The device given, or this process's card: cuda:LOCAL_RANK (torchrun's
    variable, 0 without it). Raises without a card."""
    if device is not None:
        dev = torch.device(device)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to use gloo on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Join the processes of a multi-process run.

    `coordinator_address` ("host:port") becomes a `tcp://` init method;
    without it torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    are read. The backend follows `device` (this process's card by
    default): NCCL for CUDA, gloo for the CPU, never switched quietly. With
    no coordinator configured the process stays alone and nothing is
    probed; with one configured, a failure raises (every process quietly
    running alone would be a wrong answer, not a fallback). Idempotent: a
    module flag records the first successful call."""
    global _INITIALIZED, _DEVICE
    if _INITIALIZED:
        return
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not any(os.environ.get(v) for v in _COORDINATOR_ENV):
        return
    dev = _process_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} for a process group")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kwargs)
    _DEVICE = dev
    _INITIALIZED = True


def global_mesh(local_devices: Optional[Sequence] = None) -> Mesh:
    """The mesh over every process's shards: this process's `local_devices`
    (its `init` device once by default; repeat one for virtual shards) and
    the world group, if `init` joined one."""
    if local_devices is None:
        local_devices = (_DEVICE if _DEVICE is not None else _process_device(None),)
    return Mesh(tuple(local_devices), dist.group.WORLD if dist.is_initialized() else None)


def host_local_slice(n_global: int) -> slice:
    """The [start, stop) range of the global point vector this process
    feeds: its rank's contiguous share, which covers its local shards.
    n_global must divide evenly over the processes: dropping the remainder
    would compute the wrong MSM; callers pad the global input (identity
    points, zero scalars) to a multiple of world size * local shards *
    n_chunks * chunk_len first."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_global % world != 0:
        raise ValueError(
            f"n_global={n_global} is not divisible by the world size {world}; "
            "pad the input with identity points (0, 1, 0) and zero scalars"
        )
    per_process = n_global // world
    return slice(rank * per_process, (rank + 1) * per_process)


def scaling_efficiency(t_1: float, t_n: float, n_devices: int) -> float:
    """Throughput scaling efficiency against linear: (t_1 / t_n) / n."""
    return (t_1 / t_n) / n_devices
