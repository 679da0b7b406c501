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

Two numpy arrays that meet the wire path's preconditions (whole rows,
z == 1) take the wire path of the "gpu" and "hybrid" engines; everything
else is normalized to `ExtPoint`s and ints. "oracle" and "cpu" compute on
the host and resolve no device. The others run on `device`: the GPU when
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


def _wire_point_rows(points: np.ndarray) -> Optional[np.ndarray]:
    """The point array as contiguous [n, 32] u32 rows if it meets the wire
    path's preconditions on the point side (an integer array of whole rows
    with z == 1), else None. This is the one z check of a call: the engine
    takes the rows without reading them for it again."""
    if not np.issubdtype(points.dtype, np.integer):
        return None
    if points.size == 0 or points.size % 32 != 0:
        return None
    rows = gpu_engine.as_wire_rows(points)
    return rows if gpu_engine.z_is_one(rows) else None


def _wire_inputs(points: np.ndarray, scalars: np.ndarray, rows: Optional[np.ndarray] = None):
    """(point rows, [n, 8] scalar rows) if the two arrays meet the wire
    path's preconditions, else None; checked up front so that inside the
    path any error is a real fault. Integer arrays wider than u32 are
    range-checked: a word of 2^32 or more raises instead of being cut.
    `rows`: the point array's rows, already checked."""
    with trace.span("check inputs (wire)"):
        if scalars.size != points.size // 4:  # n*8 scalar words against n*32 point words
            return None
        rows = _wire_point_rows(points) if rows is None else rows
        if rows is None:
            return None
        return rows, convert.as_u32_array(scalars, "wire scalars").reshape(-1, 8)


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

    wire = (_wire_inputs(points, scalars)
            if engine in ("gpu", "hybrid") and isinstance(points, np.ndarray)
            and isinstance(scalars, np.ndarray) else None)
    if wire is not None:  # z checked
        if _gpu_only(engine, config):
            return AffinePoint(*gpu_engine.msm_affine_wire(*wire, config, dev, True))
        return AffinePoint(*hybrid_engine.msm_affine_wire(*wire, config, dev, True))

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
    if engine == "baseline":
        return AffinePoint(*baseline_engine.msm_affine(pts, sc, config, dev))
    if _gpu_only(engine, config):
        return AffinePoint(*gpu_engine.msm_affine(pts, sc, config, dev))
    return AffinePoint(*hybrid_engine.msm_affine(pts, sc, config, dev))


def compute_msm_batch(
    points_list: Sequence[Any],
    scalars_list: Sequence[Any],
    config: Optional[MSMConfig] = None,
    device=None,
    engine: Optional[str] = None,
) -> list[AffinePoint]:
    """Many MSMs, the prover's workload: every job's device work is queued
    before any result is fetched, so the host's marshalling of one job
    overlaps the device's work on the one before.

    When every job is wire-format ([n, 32] / [n, 8] arrays, z == 1) the
    batch runs on the wire path with no per-point Python conversion; when,
    besides, every job passes the same point array object, the bases are
    copied and converted once (a `WirePlan`) and each job streams only its
    scalars. Otherwise each job is normalized and takes the planes path.

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

    wire = _wire_jobs(points_list, scalars_list)
    if wire:
        if len(wire) > 1 and all(p is points_list[0] for p in points_list):
            plan = gpu_engine.WirePlan(wire[0][0], config, dev, True)  # z checked
            results = plan.msm_affine_batch([sc for _, sc in wire])
        else:
            results = gpu_engine.msm_affine_batch_wire(wire, config, dev, True)
    else:
        jobs = [
            (_normalize_points(p), _normalize_scalars(s))
            for p, s in zip(points_list, scalars_list)
        ]
        results = gpu_engine.msm_affine_batch(jobs, config, dev)
    return [AffinePoint(x, y) for x, y in results]


def _wire_jobs(points_list: Sequence[Any], scalars_list: Sequence[Any]) -> Optional[list]:
    """Each job's `_wire_inputs` if every job meets the wire path's
    preconditions, else None. A point array that several jobs share is
    checked once."""
    jobs, checked = [], {}
    for p, s in zip(points_list, scalars_list):
        if not (isinstance(p, np.ndarray) and isinstance(s, np.ndarray)):
            return None
        job = _wire_inputs(p, s, checked.get(id(p)))
        if job is None:
            return None
        checked[id(p)] = job[0]
        jobs.append(job)
    return jobs


def _points_to_wire_rows(points: list[ExtPoint]) -> np.ndarray:
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
        if rows is None:
            # one marshal on the host to wire rows (z == 1), then the same plan
            rows = _points_to_wire_rows(_normalize_points(points))
        self._plan = gpu_engine.WirePlan(rows, self.config, self.device, True)  # z checked
        self.n = self._plan.n

    @staticmethod
    def _scalars_wire(scalars: Any) -> np.ndarray:
        with trace.span("check inputs (wire)"):
            if isinstance(scalars, np.ndarray):
                return convert.as_u32_array(scalars, "wire scalars").reshape(-1, 8)
            return convert.bigints_to_u32_be([int(s) for s in scalars])

    def _per_call(self, scalars: Any) -> AffinePoint:
        return compute_msm(self._points, scalars, config=self.config, device=self.device,
                           engine=self.engine)

    def msm(self, scalars: Any) -> AffinePoint:
        """One MSM against the planned bases."""
        if self._plan is None:
            return self._per_call(scalars)
        return AffinePoint(*self._plan.msm_affine(self._scalars_wire(scalars)))

    def msm_batch(self, scalars_list: Sequence[Any]) -> list[AffinePoint]:
        """Several jobs: all queued (scalar copies overlap the compute)
        before any result is fetched."""
        if self._plan is None:
            return [self._per_call(s) for s in scalars_list]
        wire = [self._scalars_wire(s) for s in scalars_list]
        return [AffinePoint(x, y) for x, y in self._plan.msm_affine_batch(wire)]
