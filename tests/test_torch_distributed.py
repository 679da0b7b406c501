"""The port's multi-process layer (`webgpu_msm_tpu_torch/parallel/distributed.py`
and `_multihost_worker.py`): two real gloo processes, and the pure-host logic.

`test_two_process_gloo` starts two OS processes of the worker, each
`distributed.init` with a local coordinator and four virtual CPU shards,
and runs the sharded MSM over the global mesh of 8 shards, its one
collective a gloo `all_gather`, against the oracle: the counterpart of
`tests/test_distributed.py`'s two JAX processes.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from webgpu_msm_tpu_torch.parallel import distributed
from webgpu_msm_tpu_torch.parallel.msm_sharded import Mesh

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

REPO = Path(__file__).resolve().parent.parent
PROCESS_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["window_sums", "buckets"])
def test_two_process_gloo(mode):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MSM_WORKER_LOCAL_DEVICES="4")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "webgpu_msm_tpu_torch.parallel._multihost_worker", str(pid), "2",
             str(port), mode, "--device", "cpu"],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK process={pid}/2 devices=8 mode={mode}" in out, out[-4000:]


def test_host_local_slice_rejects_indivisible(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.host_local_slice(128)
    sl = distributed.host_local_slice(96)
    assert (sl.start, sl.stop) == (32, 64)


def test_host_local_slice_single_process():
    assert not dist.is_initialized()
    sl = distributed.host_local_slice(100)
    assert (sl.start, sl.stop) == (0, 100)


@pytest.fixture
def fresh_init(monkeypatch):
    """`init` as if never called, with init_process_group recorded, not run."""
    calls = []
    monkeypatch.setattr(distributed, "_INITIALIZED", False)
    monkeypatch.setattr(distributed, "_DEVICE", None)
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_init_is_idempotent(fresh_init):
    """A configured coordinator: one init, never a second."""
    distributed.init(coordinator_address="127.0.0.1:1", num_processes=1, process_id=0, device="cpu")
    assert fresh_init == [("gloo", dict(init_method="tcp://127.0.0.1:1", world_size=1, rank=0))]
    distributed.init(coordinator_address="127.0.0.1:1", num_processes=1, process_id=0, device="cpu")
    assert len(fresh_init) == 1


def test_init_without_coordinator_stays_single(fresh_init):
    distributed.init()
    assert fresh_init == [] and not distributed._INITIALIZED


def test_init_backend_follows_device(fresh_init, monkeypatch):
    """NCCL for a card (torchrun's variables), never switched to gloo."""
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    distributed.init(device="cuda:0")
    assert fresh_init == [("nccl", {})]
    assert distributed.global_mesh().devices == (torch.device("cuda", 0),)


def test_init_failure_raises(fresh_init, monkeypatch):
    def refuse(backend, **kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="unreachable"):
        distributed.init(coordinator_address="127.0.0.1:1", num_processes=2, process_id=0, device="cpu")
    assert not distributed._INITIALIZED


def test_global_mesh_single_process():
    mesh = distributed.global_mesh(["cpu"] * 3)
    assert mesh == Mesh((torch.device("cpu"),) * 3) and mesh.group is None
    assert (mesh.size, mesh.offset, mesh.world_size, mesh.rank) == (3, 0, 1, 0)


def test_scaling_efficiency():
    assert distributed.scaling_efficiency(1.0, 0.5, 2) == 1.0
    assert distributed.scaling_efficiency(1.0, 1.0, 4) == 0.25
