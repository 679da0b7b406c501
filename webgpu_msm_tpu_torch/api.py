"""Public API: `compute_msm`, `compute_msm_batch` and `MSMPlan`, the port's
counterparts of the JAX package's.

Accepted inputs:
- points: a numpy [n, 32] array of big-endian u32 words (x||y||t||z); a
  dict with keys x/y/t/z of [n, 8] big-endian u32 arrays; or a list of
  `ExtPoint`s, (x, y) or (x, y, t, z) int tuples, or per-point dicts;
- scalars: a numpy [n, 8] big-endian u32 array, or a list of ints or of
  [8] big-endian u32 arrays.

Engines (`engine=`), routed as the JAX `compute_msm` routes its own:
- "gpu" (the default): `engines/gpu_engine.py`; with `cpu_work_ratio` > 0
  it goes to the hybrid, as the JAX "tpu" engine does;
- "hybrid": the native CPU engine and the GPU engine on one MSM at once;
- "naive": a double-and-add ladder for every point and a tree sum;
- "baseline": the Demox-Labs baseline row (host bucketing, device ladders);
- "oracle": the pure-Python serial Pippenger;
- "cpu": the native C++ engine.

Every job bound for the "gpu" and "hybrid" engines enters them as wire
rows, decided here once a job: two numpy arrays that pass `_wire_inputs`
(whole rows in the u32 range, z == 1, as many scalar rows as point rows)
are taken as they are; any other job is normalized to `ExtPoint`s and ints
and marshalled on the host to such rows (`_job_rows`). The other engines
take the normalized lists. "oracle" and "cpu" compute on the host and
resolve no device. The others run on `device`: the GPU when
none is given (an error without one), plain PyTorch only for device="cpu".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .config import MSMConfig
from .engines import baseline_engine, cpu_engine, gpu_engine, hybrid_engine, naive_engine
from .oracle import curve
from .oracle import msm as omsm
from .oracle.curve import ExtPoint
from .utils import convert, trace


@dataclass(frozen=True)
class AffinePoint:
    x: int
    y: int


ENGINES = ("gpu", "hybrid", "naive", "baseline", "oracle", "cpu")
HOST_ENGINES = ("oracle", "cpu")  # compute on the host; resolve no device


def _resolve(engine: Optional[str], device) -> tuple[str, Optional[torch.device]]:
    """(engine name, device): None means "gpu"; a host engine gets no
    device."""
    engine = "gpu" if engine is None else engine
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; the port's engines: {ENGINES}")
    return engine, None if engine in HOST_ENGINES else gpu_engine.resolve_device(device)


def _gpu_only(engine: str, config: MSMConfig) -> bool:
    """The GPU engine with no CPU share: the only route with queued batch
    dispatch and resident plans (the JAX "tpu" engine's)."""
    return engine == "gpu" and config.cpu_work_ratio == 0


def _u32_rows(arr: np.ndarray, width: int, what: str) -> np.ndarray:
    """An integer array as contiguous [n, width] u32 rows (no copy when it
    is contiguous u32). Integer arrays wider than u32 are range-checked: a
    word of 2^32 or more raises instead of being cut."""
    return np.ascontiguousarray(convert.as_u32_array(arr, what)).reshape(-1, width)


def _wire_point_rows(points: np.ndarray) -> Optional[np.ndarray]:
    """The point array as contiguous [n, 32] u32 rows if it meets the wire
    rows' preconditions on the point side (an integer array of whole rows
    with z == 1), else None."""
    if not np.issubdtype(points.dtype, np.integer):
        return None
    if points.size == 0 or points.size % 32 != 0:
        return None
    rows = _u32_rows(points, 32, "wire points")
    return rows if gpu_engine.z_is_one(rows) else None


def _wire_inputs(points: Any, scalars: Any, rows: Optional[np.ndarray] = None):
    """(point rows, [n, 8] scalar rows) if the job is two integer arrays
    that meet the wire rows' preconditions, else None. This is the one
    check of wire input: the engines take its rows without reading them
    for it again. `rows`: the job's point rows, made already for an
    earlier job of a batch that passes the same point object."""
    with trace.span("check inputs (wire)"):
        if not isinstance(scalars, np.ndarray):
            return None
        if rows is None and isinstance(points, np.ndarray) and scalars.size * 4 == points.size:
            rows = _wire_point_rows(points)
        if rows is None or scalars.size != rows.shape[0] * 8:
            return None
        return rows, _u32_rows(scalars, 8, "wire scalars")


def _wire_fast_path_ok(points: np.ndarray, scalars: np.ndarray) -> bool:
    """The JAX package's predicate of the same name."""
    return _wire_inputs(points, scalars) is not None


def _normalize_scalars(scalars: Any) -> list[int]:
    if isinstance(scalars, np.ndarray):
        return convert.u32_be_to_bigints(scalars)
    return [
        convert.u32_be_to_bigints(s.reshape(1, 8))[0] if isinstance(s, np.ndarray) else int(s)
        for s in scalars
    ]


def _normalize_points(points: Any) -> list[ExtPoint]:
    if isinstance(points, np.ndarray):
        arr = convert.as_u32_array(points, "points").reshape(-1, 32)
        points = {c: arr[:, 8 * i : 8 * i + 8] for i, c in enumerate("xytz")}
    if isinstance(points, dict):
        return [ExtPoint(*v) for v in zip(*(convert.u32_be_to_bigints(points[c]) for c in "xytz"))]
    out = []
    for p in points:
        if isinstance(p, ExtPoint):
            out.append(p)
        elif isinstance(p, dict):
            out.append(ExtPoint(int(p["x"]), int(p["y"]), int(p["t"]), int(p.get("z", 1))))
        elif len(p) == 2:
            out.append(curve.from_affine(int(p[0]), int(p[1])))
        else:
            x, y, t, z = (int(v) for v in p)
            out.append(ExtPoint(x, y, t, z))
    return out


def _job_rows(points: Any, scalars: Any, rows: Optional[np.ndarray] = None):
    """One job as the wire rows by which it enters the "gpu" and "hybrid"
    engines: the arrays as they are if they pass `_wire_inputs`, else the
    job normalized and marshalled on the host (z normalized, coordinates
    reduced mod p). `rows`: as for `_wire_inputs`."""
    wire = _wire_inputs(points, scalars, rows)
    if wire is not None:
        return wire
    with trace.span("convert inputs"):
        if rows is None:
            rows = _points_to_wire(_normalize_points(points))
        sc = _normalize_scalars(scalars)
        if rows.shape[0] != len(sc):
            raise ValueError(f"points/scalars length mismatch: {rows.shape[0]} vs {len(sc)}")
        return rows, convert.bigints_to_u32_be(sc)


def compute_msm(
    points: Any,
    scalars: Any,
    config: Optional[MSMConfig] = None,
    device=None,
    engine: Optional[str] = None,
) -> AffinePoint:
    """Compute sum_i scalars[i] * points[i]; returns the affine result.

    device: a torch device ("cuda", "cuda:0", "cpu"); None means the GPU.
    engine: one of `ENGINES`; None means "gpu".
    """
    config = config or MSMConfig()
    engine, dev = _resolve(engine, device)

    if engine in ("gpu", "hybrid"):
        rows, sc = _job_rows(points, scalars)
        if not rows.shape[0]:
            return AffinePoint(0, 1)
        entry = gpu_engine.msm_affine_wire if _gpu_only(engine, config) else hybrid_engine.msm_affine_wire
        return AffinePoint(*entry(rows, sc, config, dev))

    pts = _normalize_points(points)
    sc = _normalize_scalars(scalars)
    if len(pts) != len(sc):
        raise ValueError(f"points/scalars length mismatch: {len(pts)} vs {len(sc)}")
    if not pts:
        return AffinePoint(0, 1)

    if engine == "oracle":
        result = omsm.msm(pts, sc, window_size=config.resolved_window_size(len(pts)))
        return AffinePoint(*curve.to_affine(result))
    if engine == "cpu":
        return AffinePoint(*cpu_engine.msm_affine(pts, sc, config))
    if engine == "naive":
        return AffinePoint(*naive_engine.msm_affine(pts, sc, config, dev))
    return AffinePoint(*baseline_engine.msm_affine(pts, sc, config, dev))


def compute_msm_batch(
    points_list: Sequence[Any],
    scalars_list: Sequence[Any],
    config: Optional[MSMConfig] = None,
    device=None,
    engine: Optional[str] = None,
) -> list[AffinePoint]:
    """Many MSMs, the prover's workload: every job's device work is queued
    before any result is fetched, so the host's staging of one job
    overlaps the device's work on the one before.

    Each job becomes wire rows first, as in `compute_msm`; a point object
    that several jobs pass is checked or marshalled once. When every job
    passes the same point object, the bases are copied and converted once
    (a `WirePlan`) and each job streams only its scalars; otherwise each
    job streams its own rows.

    The queued dispatch is the GPU engine's: any other engine, or a
    co-compute split (`cpu_work_ratio` > 0), runs job by job through
    `compute_msm`, routed as it routes them.
    """
    config = config or MSMConfig()
    if len(points_list) != len(scalars_list):
        raise ValueError(
            f"points_list/scalars_list length mismatch: "
            f"{len(points_list)} vs {len(scalars_list)}"
        )
    engine, dev = _resolve(engine, device)
    if not _gpu_only(engine, config):
        return [compute_msm(p, s, config=config, device=dev, engine=engine)
                for p, s in zip(points_list, scalars_list)]

    jobs, made = [], {}
    for p, s in zip(points_list, scalars_list):
        jobs.append(_job_rows(p, s, made.get(id(p))))
        made[id(p)] = jobs[-1][0]
    if len(jobs) > 1 and all(p is points_list[0] for p in points_list):
        plan = gpu_engine.WirePlan(jobs[0][0], config, dev)
        results = plan.msm_affine_batch([sc for _, sc in jobs])
    else:
        results = gpu_engine.msm_affine_batch_wire(jobs, config, dev)
    return [AffinePoint(x, y) for x, y in results]


def _points_to_wire(points: list[ExtPoint]) -> np.ndarray:
    """Extended points -> [n, 32] BE u32 wire rows with z == 1."""
    rows = np.zeros((len(points), 32), dtype=np.uint32)
    for i, coord in enumerate(gpu_engine.affine_xyt(points)):
        rows[:, 8 * i : 8 * i + 8] = convert.bigints_to_u32_be(coord)
    rows[:, 31] = 1
    return rows


class MSMPlan:
    """Fixed-base plan: `compute_msm` with the bases fixed.

    A prover computes many MSMs against one structured reference string;
    sending the point array again for every job is waste. A plan copies the
    bases to the device and converts them to Montgomery Niels form once, at
    construction; each `msm(scalars)` then streams only [n, 8] scalar rows.

        plan = MSMPlan(points)                 # once per reference string
        results = plan.msm_batch(scalar_jobs)  # scalars only

    Points take the same forms as `compute_msm`; wire rows with z == 1 skip
    all per-point conversion on the host. The resident bases are the GPU
    engine's: with any other engine, or with `cpu_work_ratio` > 0, the plan
    keeps the points and runs each job through `compute_msm`, as the JAX
    `MSMPlan` does.
    """

    def __init__(
        self,
        points: Any,
        config: Optional[MSMConfig] = None,
        device=None,
        engine: Optional[str] = None,
    ):
        self.config = config or MSMConfig()
        self.engine, self.device = _resolve(engine, device)
        self._plan = None
        self._points = None
        if not _gpu_only(self.engine, self.config):
            self._points = points
            self.n = (points.reshape(-1, 32).shape[0] if isinstance(points, np.ndarray)
                      else len(points))
            return
        with trace.span("check inputs (wire)"):
            rows = _wire_point_rows(points) if isinstance(points, np.ndarray) else None
        if rows is None:  # one marshal on the host to wire rows (z == 1), then the same plan
            with trace.span("convert inputs"):
                rows = _points_to_wire(_normalize_points(points))
        self._plan = gpu_engine.WirePlan(rows, self.config, self.device)
        self.n = self._plan.n

    def _job_scalars(self, scalars: Any) -> np.ndarray:
        """One job's [n, 8] u32 scalar rows, one for each planned base."""
        with trace.span("check inputs (wire)"):
            if isinstance(scalars, np.ndarray):
                sc = _u32_rows(scalars, 8, "wire scalars")
            else:
                sc = convert.bigints_to_u32_be(_normalize_scalars(scalars))
            if sc.shape[0] != self.n:
                raise ValueError(f"plan holds {self.n} bases but got {sc.shape[0]} scalars")
            return sc

    def _per_call(self, scalars: Any) -> AffinePoint:
        return compute_msm(self._points, scalars, config=self.config, device=self.device,
                           engine=self.engine)

    def msm(self, scalars: Any) -> AffinePoint:
        """One MSM against the planned bases."""
        if self._plan is None:
            return self._per_call(scalars)
        return AffinePoint(*self._plan.msm_affine(self._job_scalars(scalars)))

    def msm_batch(self, scalars_list: Sequence[Any]) -> list[AffinePoint]:
        """Several jobs: all queued (scalar copies overlap the compute)
        before any result is fetched."""
        if self._plan is None:
            return [self._per_call(s) for s in scalars_list]
        wire = [self._job_scalars(s) for s in scalars_list]
        return [AffinePoint(x, y) for x, y in self._plan.msm_affine_batch(wire)]
