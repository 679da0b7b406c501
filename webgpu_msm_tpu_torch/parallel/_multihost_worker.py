"""One process of a multi-process sharded MSM (the test and dryrun harness).

Runs the real multi-process layer: `distributed.init` with an explicit
coordinator, `distributed.global_mesh`, `distributed.host_local_slice` and
the sharded stages with their collective, on gloo CPU processes or on
NCCL ranks, one card each.

    python -m webgpu_msm_tpu_torch.parallel._multihost_worker \\
        <process_id> <num_processes> <coordinator_port> [mode] [--device cpu|cuda]

Env: MSM_WORKER_LOCAL_DEVICES, the virtual shards a process drives on its
device (default 4). The device is the card by default (process i on
cuda:i mod the card count); `--device cpu` runs gloo and the kernels'
plain versions.

Each process builds the same global inputs from their seeds, feeds only its
`host_local_slice`, and checks the result, the same on every process,
against the oracle; it prints "MULTIHOST_OK ..." on success, with the
stage graphs it captured (none on the CPU).
"""
from __future__ import annotations

import argparse
import os
import sys

W, C, L = 8, 4, 4  # window, and the chunking of each shard


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("mode", nargs="?", default="window_sums")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    pid, nproc = args.process_id, args.num_processes
    local_devices = int(os.environ.get("MSM_WORKER_LOCAL_DEVICES", "4"))

    import torch
    import torch.distributed as dist

    from ..engines import gpu_engine
    from ..oracle import curve
    from ..oracle import msm as omsm
    from ..ops import limbs
    from ..ops.kernels import padd_kernels as pk
    from ..utils import cache, fixtures
    from ..utils.interop import planes_from_numpy
    from . import distributed
    from .msm_sharded import sharded_stages, window_sums_affine

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        device = torch.device("cuda", pid % torch.cuda.device_count())
    else:
        device = torch.device("cpu")
    distributed.init(
        coordinator_address=f"127.0.0.1:{args.port}", num_processes=nproc, process_id=pid,
        device=device,
    )
    if dist.get_world_size() != nproc:
        raise RuntimeError(f"world size {dist.get_world_size()}, not {nproc}")

    mesh = distributed.global_mesh([device] * local_devices)
    D = mesh.size
    n_global = D * C * L

    # The same global inputs on every process; each feeds only its slice.
    pts = fixtures.distinct_points_fast(n_global, seed=5)
    scalars = fixtures.random_scalars(n_global, seed=6)
    sl = distributed.host_local_slice(n_global)
    planes = planes_from_numpy(gpu_engine.marshal_points(pts, n_global)[:, :, sl], device)
    words = planes_from_numpy(gpu_engine.marshal_scalars(scalars, n_global)[:, sl], device)
    niels = pk.to_niels(planes)

    # Every stage before the collective runs freely (on a card each captures
    # its graph at its first call); the processes meet at a barrier before
    # the combine stage, so that none waits in the collective while another
    # is still queueing its shards or capturing (the JAX worker's compile
    # barrier). The combine stage captures the graphs after the all-gather
    # before it enters it.
    stages = sharded_stages(window_size=W, n_chunks=C, chunk_len=L, mesh=mesh, mode=args.mode)

    def run():
        out = stages[0][1](niels, words)
        idx = 1
        while stages[idx][0] != "combine":
            out = stages[idx][1](out)
            idx += 1
        dist.barrier()
        print(f"[worker {pid}] at the collective", flush=True)
        for _, fn in stages[idx:]:
            out = fn(out)
        return out

    print(f"[worker {pid}] running the pre-collective stages", flush=True)
    out = run()
    got = window_sums_affine(limbs.as_i64(out), W)
    want = curve.to_affine(omsm.msm(pts, scalars, window_size=W))
    if got != want:
        raise RuntimeError(f"process {pid}: {got} != the oracle's {want}")
    if device.type == "cuda":  # a call that replays every graph, and one without them
        replayed = run()
        with cache.eager():
            eager = run()
        if not (torch.equal(replayed, out) and torch.equal(eager, out)):
            raise RuntimeError(f"process {pid}: the graph replays or the eager stages differ")
    print(
        f"MULTIHOST_OK process={pid}/{nproc} devices={D} mode={args.mode} "
        f"device={device} captures={cache.stats()['captures']} x={got[0]}",
        flush=True,
    )
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
