"""Stage graphs: each pipeline stage captured once as a CUDA graph, then
replayed. The counterpart of the JAX package's `utils/cache.py` and of the
program cache behind its engine's `_call_stage`.

The JAX engine runs every stage of the pipeline (a batch, the plan's point
conversion, the finish) as one compiled program, traced once per stage
name. On the card the counterpart of a compiled stage program is a CUDA
graph: the stage's kernel launches and plain PyTorch ops, recorded once
and then launched as one.

`stage_call(name, fn, *args)` (every argument a tensor, and on the card
the result one tensor):

- With no argument on a CUDA device it returns `fn(*args)`: there are no
  graphs on the CPU, as the JAX engine uses no exports off a TPU.
- On the card the graph is keyed by the stage name, which must encode
  every static of `fn` (as in JAX), each argument's shape and dtype, and
  the device. The first call at a new key runs `fn` eagerly, which gives
  its result and creates the constants that the ops cache lazily (their
  pageable copies are illegal while capturing), then captures `fn` on
  input buffers of the graph's own. A later call copies its arguments into
  those buffers (`copy_`, non_blocking; from pinned host memory that copy
  is the batch's host-to-device copy) and replays the graph. Host tensors
  among the arguments go to the card of the CUDA ones. A capture that
  fails raises with the stage's name: nothing falls back to an eager run.

Outputs. A replay writes into the graph's own output tensor. With
`clone=True` (the default) the caller gets copies made on the stream
right after the replay, so a result outlives the next replay of its
stage: a queued job's window sums, the plan's resident rows. With
`clone=False` the caller gets the graph's tensor, valid until the stage
is called again: a batch's bucket carry, which the next batch stage copies
into its input buffer before it replays.

Launch counts. A capture records the kernel launches of `fn` without
running them: the cache takes them back out of `padd_kernels.launches`
and adds them again at every replay, so the counts are an eager run's.
`chip_smoke.py` holds each graph's recorded launches to its kernel
nodes, by symbol as the CUDA driver reads them from the graph.

Memory. A graph holds a private memory pool (the intermediates and
outputs of `fn`) and its input buffers. The graphs of one card hold at
most `limit(device)` bytes, `MEMORY_SHARE` of its memory: after a capture
the least recently used others are dropped until they fit. A graph larger
than half the limit is not kept, and its stage runs eagerly at that key
from then on (`stats()["too_large"]`): so the two graphs of one call (a
batch stage and the finish) always fit together and a call never drops
its own. While the card has less than the limit free, read after the
allocator's unused blocks are released, a first call captures nothing
(`stats()["uncaptured"]`) and the next call at its key tries again. A
dropped graph's pool goes back to the device once no tensor of it is
held.

One stream. Copies, replays and clones are queued on the current stream
of the stage's device, as the eager stages are: a caller that switches
streams between jobs synchronizes first. A capture runs on a stream of
its own, one at a time in the process (a lock), in CUDA's thread-local
capture mode: only the capturing thread is barred from the calls that
are illegal while capturing, so other threads of the process (the hybrid
engine's CPU worker, a loader pinning host memory) go on as usual, and
their work, queued on other streams, is not recorded.

Spans. Each call is a `utils/trace.span` "stage <name>: <outcome>", the
outcome `replay`, `capture` (a first call: its eager run, then the
capture) or `eager` (on the CPU, under `eager()`, a graph too large, a
key `prepare` left uncaptured, a first call while the card is short of
memory). `stats()["eager"]` counts the eager runs on a card: with
`captures`, what a warm call should never add to.

`prepare(name, fn, *args)` captures a stage's graph ahead of its first
call, on stand-in arguments of its shapes: the multi-GPU layer's stages
after the collective (`parallel/msm_sharded.py`). While the card is short
of memory it runs nothing and marks the key, and the key's next call runs
its stage eagerly without trying to capture; the next `prepare` tries
again.

`eager()`: a context manager under which `stage_call` runs `fn` directly
on the card too, its host arguments copied there first: the counterpart
of the JAX package's `MSM_NO_EXPORT_CACHE=1`. The tests and
`chip_smoke.py`'s A/B of the two use it; no path does.

What has no counterpart here: the persistent half of the JAX module (the
compilation cache, the committed AOT seed, exports keyed by a hash of the
source tree). Its role is played by `ops/kernels/build.py`'s kernel
library, built once per hash of sources and flags and loaded by later
processes. Graphs live for one process: each new process captures anew.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import torch

from ..ops.kernels import padd_kernels as pk
from . import trace

MEMORY_SHARE = 0.125  # of a card's memory: what its graphs may hold, and what must stay free to capture


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple  # the buffers the graph reads its arguments from
    output: torch.Tensor  # what fn returned while captured: the tensor a replay writes
    launches: dict  # the kernel launches of one replay
    nbytes: int  # its pool and its input buffers


def _stage_device(args) -> torch.device | None:
    """The card of the stage's CUDA tensors, or None if all lie on the CPU."""
    for a in args:
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"stage arguments must be tensors, got {type(a).__name__}")
    devices = {a.device for a in args if a.device.type != "cpu"}
    if not devices:
        return None
    if len(devices) > 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"stage arguments on {sorted(map(str, devices))}: one CUDA device expected")
    return devices.pop()


def _key(name: str, device: torch.device, args) -> tuple:
    return name, device, tuple((tuple(a.shape), a.dtype) for a in args)


def _on(device: torch.device, args) -> tuple:
    return tuple(a if a.device == device else a.to(device, non_blocking=True) for a in args)


def _card_memory(device: torch.device) -> tuple[int, int]:
    """(bytes free, bytes in all) of the card, the allocator's unused
    blocks released first."""
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info(device)


def limit(device: torch.device) -> int:
    """The most bytes the graphs of `device` may hold."""
    return int(MEMORY_SHARE * torch.cuda.get_device_properties(device).total_memory)


def _pool_bytes(graph) -> int:
    """Bytes of the device segments that the graph's private pool holds."""
    pool = tuple(graph.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)


def _capture(fn: Callable, inputs: tuple, device: torch.device):
    """(graph, its output): fn captured on `inputs`, on a new stream."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(
            graph, stream=torch.cuda.Stream(device), capture_error_mode="thread_local"):
        output = fn(*inputs)
    return graph, output


class StageCache:
    """Least recently used CUDA graphs of pipeline stages; see the module
    docstring. `captures`, `replays`, `eager_runs` (the calls on a card
    that ran without a graph), `evictions` and `uncaptured` count since the
    last `clear`; `peak_bytes` is the most held at once, a new
    graph included before the limit drops others; `too_large` maps the keys
    whose graph passed half the limit to its bytes."""

    def __init__(self):
        self._graphs: OrderedDict[tuple, _Graph] = OrderedDict()
        self.too_large: dict[tuple, int] = {}
        self._unprepared: set[tuple] = set()  # keys `prepare` left uncaptured
        self._eager = 0
        self._lock = threading.Lock()
        self.captures = self.replays = self.eager_runs = 0
        self.evictions = self.uncaptured = self.peak_bytes = 0

    def held(self, device: torch.device | None = None) -> int:
        """Bytes the graphs hold, on `device` or on every card."""
        return sum(g.nbytes for k, g in self._graphs.items() if device in (None, k[1]))

    def call(self, name: str, fn: Callable, *args, clone: bool = True):
        device = _stage_device(args)
        if device is None:
            with trace.span(f"stage {name}: eager"):
                return fn(*args)
        with self._lock:
            key = _key(name, device, args)
            outcome = self._outcome(key, device)
            with trace.span(f"stage {name}: {outcome}"):
                if outcome == "capture":
                    return self._first_call(key, fn, device, args)
                if outcome == "eager":
                    self.eager_runs += 1
                    return fn(*_on(device, args))
                entry = self._graphs[key]
                self._graphs.move_to_end(key)
                for buf, a in zip(entry.inputs, args):
                    buf.copy_(a, non_blocking=True)
                entry.graph.replay()
                pk.add_launches(entry.launches)
                self.replays += 1
                return entry.output.clone() if clone else entry.output

    def _outcome(self, key: tuple, device: torch.device) -> str:
        """What a call at `key` does: "replay" its graph, "capture" one (a
        first call with the memory to), or run "eager" (under `eager()`, a
        graph too large, a key `prepare` left uncaptured, a first call while
        the card is short of memory)."""
        if self._eager or key in self.too_large:
            return "eager"
        if key in self._unprepared:  # no capture where `prepare` found no memory
            self._unprepared.discard(key)
            return "eager"
        if key in self._graphs:
            return "replay"
        if _card_memory(device)[0] < limit(device):
            self.uncaptured += 1
            return "eager"
        return "capture"

    def prepare(self, name: str, fn: Callable, *args) -> None:
        """Capture the graph at the key of `args` now, unless it is held,
        left eager or the cache is in `eager()`: the first call's eager run
        and capture, with the eager run's result dropped and its launches
        taken back out of the counts. A stage whose arguments come out of a
        collective is prepared on stand-ins of the same shapes before the
        collective: a capture synchronizes the card first, and must not wait
        behind a collective that a peer has not joined yet. While the card
        is short of memory nothing runs, and the key's next call runs
        eagerly, so that nothing is captured after the collective."""
        device = _stage_device(args)
        if device is None:
            return
        with self._lock:
            key = _key(name, device, args)
            if self._eager or key in self.too_large or key in self._graphs:
                return
            if _card_memory(device)[0] < limit(device):
                self.uncaptured += 1
            else:
                with pk.recorded_launches():
                    self._first_call(key, fn, device, args)
            if key in self._graphs or key in self.too_large:
                self._unprepared.discard(key)
            else:
                self._unprepared.add(key)

    def _first_call(self, key: tuple, fn: Callable, device: torch.device, args):
        """Run fn eagerly (its result is returned), then capture it, and
        keep the graph if it fits. The caller has found the card's memory
        enough."""
        out = fn(*_on(device, args))
        bound = limit(device)
        inputs = tuple(torch.empty(a.shape, dtype=a.dtype, device=device) for a in args)
        with pk.recorded_launches() as launches:
            try:
                graph, output = _capture(fn, inputs, device)
            except Exception as e:
                e.add_note(f"while capturing stage {key[0]} as a CUDA graph")
                raise
        nbytes = _pool_bytes(graph) + sum(b.numel() * b.element_size() for b in inputs)
        self.captures += 1
        if 2 * nbytes > bound:
            self.too_large[key] = nbytes
            del graph, output, inputs
            torch.cuda.empty_cache()
            return out
        self._graphs[key] = _Graph(graph, inputs, output, launches, nbytes)
        self.peak_bytes = max(self.peak_bytes, self.held())
        self._evict(device, bound)
        return out

    def _evict(self, device: torch.device, bound: int) -> None:
        """Drop the least recently used graphs of `device` but the newest
        until they hold at most `bound` bytes."""
        dropped = False
        for key in [k for k in self._graphs if k[1] == device][:-1]:
            if self.held(device) <= bound:
                break
            del self._graphs[key]
            self.evictions += 1
            dropped = True
        if dropped:
            torch.cuda.empty_cache()  # free the dropped pools now

    @contextlib.contextmanager
    def eager(self):
        with self._lock:
            self._eager += 1
        try:
            yield
        finally:
            with self._lock:
                self._eager -= 1

    def clear(self) -> None:
        """Drop every graph and zero the counts."""
        with self._lock:
            self._graphs.clear()
            self.too_large.clear()
            self._unprepared.clear()
            self.captures = self.replays = self.eager_runs = 0
            self.evictions = self.uncaptured = self.peak_bytes = 0
        torch.cuda.empty_cache()

    def stats(self) -> dict:
        return {"graphs": len(self._graphs), "captures": self.captures, "replays": self.replays,
                "eager": self.eager_runs, "evictions": self.evictions, "uncaptured": self.uncaptured,
                "bytes": self.held(), "peak_bytes": self.peak_bytes,
                "too_large": sorted(k[0] for k in self.too_large)}


# The process's stage graphs, which the engines' stages go through.
CACHE = StageCache()


def stage_call(name: str, fn: Callable, *args, clone: bool = True):
    return CACHE.call(name, fn, *args, clone=clone)


def prepare(name: str, fn: Callable, *args) -> None:
    CACHE.prepare(name, fn, *args)


def eager():
    return CACHE.eager()


def clear() -> None:
    CACHE.clear()


def stats() -> dict:
    return CACHE.stats()
