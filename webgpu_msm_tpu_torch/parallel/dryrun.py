"""Dry runs of the multi-GPU layer on tiny shapes, held against the oracle.

The counterparts of the JAX package's `__graft_entry__.dryrun_multichip`
and `dryrun_multihost`, with their statics (w 8, C 8 x L 8 a shard,
signed digits, the "window_sums" mode):

    python -m webgpu_msm_tpu_torch.parallel.dryrun [n_devices] [--device cpu]
    python -m webgpu_msm_tpu_torch.parallel.dryrun multihost [n_processes] [--device cpu]

Without `--device` they run on the card: `n_devices` cards of this host, or
one NCCL rank a card; `--device cpu` runs a virtual mesh, or gloo
processes, on the CPU with the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np

W, C, L = 8, 8, 8  # window, and the chunking of each shard
PROCESS_TIMEOUT_S = 900  # a process of dryrun_multihost that runs longer hangs


def _tiny_inputs(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n copies of the base point as [3, 16, n] plain (x, y, t) digit planes,
    and [8, n] LE scalar words below 2^253 from a seeded generator."""
    from ..oracle import field
    from ..oracle.testdata import base_point

    b = base_point()
    planes = np.empty((3, 16, n), dtype=np.uint32)
    for c, v in enumerate((b.x % field.P, b.y % field.P, b.t % field.P)):
        for d in range(16):
            planes[c, d] = (v >> (16 * d)) & 0xFFFF
    words = np.random.default_rng(7).integers(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    words[7] &= 0x1FFFFFFF
    return planes, words


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded MSM over an n-shard mesh (`default_mesh(n_devices,
    device)`: n cards, or n virtual shards on `device`), against the
    oracle's result for the same points and scalars."""
    t0 = time.perf_counter()
    mark = lambda label: print(f"[dryrun +{time.perf_counter() - t0:7.1f}s] {label}", flush=True)

    from ..oracle import curve
    from ..oracle import msm as omsm
    from ..oracle.testdata import base_point
    from ..ops.kernels import padd_kernels as pk
    from ..utils import convert
    from ..utils.interop import planes_from_numpy
    from .msm_sharded import default_mesh, msm_window_sums_sharded, window_sums_affine

    mesh = default_mesh(n_devices, device)
    n = mesh.size * C * L
    planes, words = _tiny_inputs(n)
    dev = mesh.devices[0]
    niels = pk.to_niels(planes_from_numpy(planes, dev))
    mark(f"inputs on {dev} ({mesh.size} shards of {C * L} points)")
    wsums = msm_window_sums_sharded(
        niels, planes_from_numpy(words, dev), window_size=W, n_chunks=C, chunk_len=L, mesh=mesh,
        mode="window_sums", signed_digits=True,
    )
    got = window_sums_affine(wsums, W)
    mark("sharded MSM step done and decoded")
    scalars = convert.words_le_to_bigints(words)
    want = curve.to_affine(omsm.msm([base_point()] * n, scalars, window_size=W))
    if got != want:
        raise AssertionError(f"multichip dryrun mismatch: {got} != {want}")
    mark("equal to the oracle")


def dryrun_multihost(n_processes: int = 2, device=None) -> None:
    """n_processes OS processes of `_multihost_worker` (NCCL ranks, one card
    each, or gloo processes with `device="cpu"`, 4 virtual shards each)
    running the sharded MSM over the global mesh. Each process has
    PROCESS_TIMEOUT_S; on a timeout every process is killed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev_args = [] if device is None else ["--device", str(device)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "webgpu_msm_tpu_torch.parallel._multihost_worker", str(pid),
             str(n_processes), str(port), *dev_args],
            env=dict(os.environ), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(n_processes)
    ]
    outs = []
    try:
        for pid, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                partial = p.communicate()[0]
                raise AssertionError(
                    f"multihost process {pid} timed out after {PROCESS_TIMEOUT_S} s; "
                    f"partial output:\n{partial[-4000:]}"
                )
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"process {pid} failed:\n{out[-4000:]}")
        if f"MULTIHOST_OK process={pid}/{n_processes}" not in out:
            raise AssertionError(out[-2000:])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", nargs="*", help="[n_devices] or multihost [n_processes]")
    ap.add_argument("--device", default=None, help="torch device; default: the GPU")
    args = ap.parse_args(argv)
    if args.what[:1] == ["multihost"]:
        n = int(args.what[1]) if len(args.what) > 1 else 2
        dryrun_multihost(n, args.device)
        print(f"dryrun_multihost({n}) OK")
    else:
        n = int(args.what[0]) if args.what else 8
        dryrun_multichip(n, args.device)
        print(f"dryrun_multichip({n}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
