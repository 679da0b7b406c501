"""The stage programs: `gpu_engine._call_stage` and `utils/cache.py`.

(a) The port's stage calls carry the JAX engine's stage names, statics and
    argument shapes: both engines' `_call_stage` are replaced by a recorder
    that returns its last argument (the carry, or the plan's input rows), so
    nothing is compiled and nothing runs past the dispatch.
(b) On the CPU `stage_call` runs the stage as it is.
(c) The cache's bookkeeping, with a stub in place of `torch.cuda.CUDAGraph`
    and the CPU standing in for the card: keys, replays, launch counts,
    the memory limit, `eager()`, a capture that fails, `prepare`, the
    sharded stages' captures before their collective, and each call's
    span "stage <name>: <outcome>" with the eager runs' count.

The graphs themselves run on the card: tests/test_torch_gpu.py.
"""
import contextlib
import socket

import numpy as np
import pytest
import torch

from webgpu_msm_tpu import config as jconfig
from webgpu_msm_tpu.engines import tpu_engine as te

from webgpu_msm_tpu_torch import MSMConfig, api, compute_msm
from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.ops.kernels import padd_kernels as pk
from webgpu_msm_tpu_torch.utils import cache, convert, fixtures, trace

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

N = 40  # three batches of 16, the last one padded
STATIC = dict(window_size=8, n_chunks=4, chunk_len=4)
CPU = torch.device("cpu")


def recorder(calls):
    def call_stage(name, fn, static_kw, *args, **kw):
        calls.append((name, dict(static_kw), [tuple(a.shape) for a in args],
                      [str(a.dtype).split(".")[-1] for a in args]))
        return args[-1]
    return call_stage


def dispatch_both(path, signed, affine, monkeypatch):
    """The JAX engine's and the port's stage calls for one dispatch."""
    pts = fixtures.distinct_points_fast(N, seed=90)
    scalars = fixtures.random_scalars(N, seed=91)
    pw, sw = fixtures.wire_points(pts), convert.bigints_to_u32_be(scalars)
    jcfg = jconfig.MSMConfig(signed_digits=signed, device_affine=affine, **STATIC)
    cfg = MSMConfig(signed_digits=signed, device_affine=affine, **STATIC)
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(te, "_call_stage", recorder(calls["jax"]))
    monkeypatch.setattr(gpu_engine, "_call_stage", recorder(calls["port"]))
    if path == "wire":
        te._dispatch_wire(pw, sw, jcfg)
        gpu_engine._dispatch_wire(pw, sw, cfg, CPU)
    elif path == "plan":
        te.WirePlan(pw, jcfg).dispatch(sw)
        gpu_engine.WirePlan(pw, cfg, CPU).dispatch(sw)
    elif path == "lists":  # marshalled by the API to the rows the JAX wire path takes
        te._dispatch_wire(api._points_to_wire(pts), sw, jcfg)
        monkeypatch.setattr(gpu_engine, "_fetch_affine", lambda out, w: (0, 1))
        compute_msm(pts, scalars, config=cfg, device=CPU)
    else:  # plain planes already on the device
        import jax.numpy as jnp
        planes, words = gpu_engine.marshal_points(pts, 48), gpu_engine.marshal_scalars(scalars, 48)
        kw = dict(signed_digits=signed, device_affine=affine, **STATIC)
        te._device_msm(jnp.asarray(planes), jnp.asarray(words), **kw)
        gpu_engine._device_msm(torch.from_numpy(planes.view(np.int32)),
                               torch.from_numpy(words.view(np.int32)), **kw)
    return calls


@pytest.mark.parametrize("affine", [False, True], ids=["finish", "device_affine"])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("path", ["wire", "plan", "lists", "resident"])
def test_stage_names_and_shapes_equal_the_jax_engine(path, signed, affine, monkeypatch):
    calls = dispatch_both(path, signed, affine, monkeypatch)
    jax_calls, port_calls = calls["jax"], calls["port"]
    assert [c[:3] for c in port_calls] == [c[:3] for c in jax_calls]
    # u32 words: uint32 in JAX, the same bits as int32 in the port
    for (*_, jdt), (*_, pdt) in zip(jax_calls, port_calls):
        assert jdt == ["uint32"] * len(jdt) and pdt == ["int32"] * len(pdt)
    s = int(signed)
    batch = {"plan": "fixed_batch", "resident": "batch_planes"}.get(path, "wire_batch")
    want = (["plan_niels_m16"] * 3 if path == "plan" else []) + [f"{batch}_w8_c4x4_s{s}"] * 3
    finish = "finish_affine" if affine else "finish"
    assert [c[0] for c in port_calls] == want + [f"{finish}_w8_s{s}"]


def test_stage_call_on_the_cpu_runs_the_stage_as_it_is():
    args = (torch.arange(6, dtype=torch.int32), torch.ones(2, 3, dtype=torch.int64))
    out = (torch.zeros(3), torch.ones(1))
    seen = []
    before = cache.stats()
    got = cache.stage_call("cpu_stage", lambda *a: seen.append(a) or out, *args)
    assert got is out and seen == [args]
    got = gpu_engine._call_stage("cpu_stage_w3", lambda x, *, k: x * k, {"k": 3}, args[0], clone=False)
    assert torch.equal(got, args[0] * 3)
    assert cache.stats() == before  # no graph, no replay
    with pytest.raises(TypeError):
        cache.stage_call("not_a_tensor", lambda x: x, 3)


# ---------------------------------------------------------------------------
# (c) the cache's bookkeeping, the CPU standing in for the card
# ---------------------------------------------------------------------------


class StubGraph:
    """Stands in for torch.cuda.CUDAGraph: records its capture and replays."""

    def __init__(self):
        self.mode, self.ended, self.replays = None, False, 0

    def replay(self):
        self.replays += 1

    def pool(self):
        return 0, id(self)


@contextlib.contextmanager
def stub_graph_capture(graph, stream=None, capture_error_mode="global"):
    """Stands in for torch.cuda.graph: the block runs as it is."""
    graph.mode = capture_error_mode
    try:
        yield
    finally:
        graph.ended = True


PER_GRAPH = 500 + 2 * 4 * 4  # a stub pool and two int32 input buffers of 4


@pytest.fixture
def stub_card(monkeypatch):
    """Every stage 'on the card' (the CPU), graphs stubbed; each graph's
    pool is 500 bytes. Yields the card's memory: a limit of four graphs
    and its free bytes, which a test may change."""
    card = {"limit": 4 * PER_GRAPH, "free": 1 << 30}
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", stub_graph_capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(cache, "_stage_device", lambda args: CPU)
    monkeypatch.setattr(cache, "_pool_bytes", lambda graph: 500)
    monkeypatch.setattr(cache, "limit", lambda device: card["limit"])
    monkeypatch.setattr(cache, "_card_memory", lambda device: (card["free"], 8 * card["limit"]))
    saved = dict(pk.launches)
    yield card
    pk.launches.update(saved)


def counting_stage(calls):
    """A stage that launches one 'kernel' (the count `_launch` keeps) and
    returns 2 * x + y."""
    def stage(x, y):
        calls.append(1)
        pk.launches["lane_scan"] += 1
        return 2 * x + y
    return stage


def test_cache_key_covers_name_shapes_dtypes_and_device(stub_card):
    stub_card["limit"] = 8 * PER_GRAPH  # room for all four graphs
    c = cache.StageCache()
    calls = []
    fn = counting_stage(calls)
    x = torch.arange(4, dtype=torch.int32)
    c.call("a", fn, x, x)
    c.call("a", fn, x, x)                                  # replay
    c.call("b", fn, x, x)                                  # another name
    c.call("a", fn, x[:3], x[:3])                          # another shape
    c.call("a", fn, x.to(torch.int64), x.to(torch.int64))  # another dtype
    assert (c.captures, c.replays) == (4, 1) and c.stats()["graphs"] == 4
    args = (x, x)
    keys = {cache._key("a", torch.device("cuda", i), args) for i in (0, 1)}
    assert len(keys) == 2 and cache._key("a", CPU, args) == cache._key("a", CPU, (x.clone(), x))


def test_second_call_replays_and_copies_its_arguments_in(stub_card):
    c = cache.StageCache()
    calls = []
    fn = counting_stage(calls)
    x, y = torch.arange(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32)
    first = c.call("s", fn, x, y)
    assert torch.equal(first, 2 * x + y) and len(calls) == 2  # the eager run, then the capture
    (entry,) = c._graphs.values()
    assert entry.graph.mode == "thread_local" and entry.graph.ended
    x2 = x + 10
    shared = c.call("s", fn, x2, y, clone=False)
    owned = c.call("s", fn, x2, y)
    assert len(calls) == 2 and entry.graph.replays == 2  # no new capture
    assert torch.equal(entry.inputs[0], x2) and torch.equal(entry.inputs[1], y)
    assert shared is entry.output and owned is not entry.output
    assert torch.equal(owned, entry.output)
    assert c.stats()["bytes"] == PER_GRAPH  # the pool and the two input buffers


def test_launch_counts_are_added_once_a_replay(stub_card):
    c = cache.StageCache()
    fn = counting_stage([])
    x = torch.arange(4, dtype=torch.int32)
    pk.reset_launch_counts()
    c.call("s", fn, x, x)
    assert pk.launches["lane_scan"] == 1  # the eager run; the capture's launch taken back out
    (entry,) = c._graphs.values()
    assert entry.launches == {"lane_scan": 1}
    for _ in range(3):
        c.call("s", fn, x, x)
    assert pk.launches["lane_scan"] == 4 and c.replays == 3
    assert sum(pk.launches.values()) == 4


def test_graphs_stay_within_the_limit_least_recently_used_first(stub_card):
    x = torch.arange(4, dtype=torch.int32)
    fn = counting_stage([])
    c = cache.StageCache()
    for name in ("a", "b", "c", "d", "a", "e"):  # "a" used again, so "b" is the least recent
        c.call(name, fn, x, x)
    assert [k[0] for k in c._graphs] == ["c", "d", "a", "e"] and c.evictions == 1
    assert c.stats()["bytes"] == c.held(CPU) == 4 * PER_GRAPH == stub_card["limit"]
    assert c.peak_bytes == 5 * PER_GRAPH  # the new graph, before the limit dropped the oldest
    c.clear()
    assert c.stats()["graphs"] == c.stats()["captures"] == c.stats()["bytes"] == 0


def test_a_call_keeps_its_two_graphs_at_the_limit(stub_card):
    """Two graphs of at most half the limit each always fit: the finish's
    capture drops older graphs, never the call's batch graph."""
    stub_card["limit"] = 2 * PER_GRAPH
    x = torch.arange(4, dtype=torch.int32)
    c = cache.StageCache()
    c.call("other", counting_stage([]), x, x)
    for _ in range(3):
        for name in ("batch", "batch", "finish"):
            c.call(name, counting_stage([]), x, x)
    assert [k[0] for k in c._graphs] == ["batch", "finish"]
    assert (c.captures, c.replays, c.evictions) == (3, 7, 1) and c.held() == stub_card["limit"]


def test_a_graph_past_half_the_limit_is_dropped_and_its_stage_runs_eagerly(stub_card):
    stub_card["limit"] = 2 * PER_GRAPH - 1
    x = torch.arange(4, dtype=torch.int32)
    calls = []
    c = cache.StageCache()
    pk.reset_launch_counts()
    for _ in range(3):
        assert torch.equal(c.call("wire_batch_w20_c2048x512_s0", counting_stage(calls), x, x), 3 * x)
    assert len(calls) == 4  # the first call's eager run and capture, then two eager runs
    assert pk.launches["lane_scan"] == 3  # the capture's launch taken back out
    s = c.stats()
    assert (s["graphs"], s["bytes"], s["captures"], s["replays"]) == (0, 0, 1, 0)
    assert s["too_large"] == ["wire_batch_w20_c2048x512_s0"]
    c.call("small", counting_stage(calls), x[:1], x[:1])  # another key is still captured
    assert c.stats()["graphs"] == 1


def test_nothing_is_captured_while_the_card_is_short_of_memory(stub_card):
    x = torch.arange(4, dtype=torch.int32)
    calls = []
    c = cache.StageCache()
    stub_card["free"] = stub_card["limit"] - 1
    for _ in range(2):
        assert torch.equal(c.call("s", counting_stage(calls), x, x), 3 * x)
    assert len(calls) == 2 and (c.captures, c.uncaptured) == (0, 2) and not c._graphs
    stub_card["free"] = stub_card["limit"]
    c.call("s", counting_stage(calls), x, x)
    c.call("s", counting_stage(calls), x, x)
    assert len(calls) == 4 and (c.captures, c.replays, c.uncaptured) == (1, 1, 2)


def test_eager_bypasses_the_graphs(stub_card):
    c = cache.StageCache()
    calls = []
    fn = counting_stage(calls)
    x = torch.arange(4, dtype=torch.int32)
    with c.eager():
        for _ in range(3):
            assert torch.equal(c.call("s", fn, x, x), 3 * x)
    assert len(calls) == 3 and (c.captures, c.replays) == (0, 0)
    c.call("s", fn, x, x)
    assert c.captures == 1


def test_a_failed_capture_raises_with_the_stage_name(stub_card):
    """No fall back to the eager run: the error reaches the caller, the
    capture is ended, and no graph is kept."""
    c = cache.StageCache()
    calls = []

    def fn(x):
        calls.append(1)
        if len(calls) == 2:  # the capture
            raise RuntimeError("operation not permitted when stream is capturing")
        return x

    with pytest.raises(RuntimeError, match="not permitted") as info:
        c.call("wire_batch_w13_c2048x128_s1", fn, torch.zeros(2))
    assert any("wire_batch_w13_c2048x128_s1" in note for note in info.value.__notes__)
    assert c.stats()["graphs"] == c.captures == 0


def test_prepare_captures_ahead_and_counts_no_launch(stub_card):
    """`prepare` runs a new key's first call (the eager run, then the
    capture) with its launches taken back out; a held key, a key left eager
    and `eager()` make it do nothing. The next call replays."""
    c = cache.StageCache()
    calls = []
    x = torch.arange(4, dtype=torch.int32)
    pk.reset_launch_counts()
    c.prepare("s", counting_stage(calls), x, x)
    assert len(calls) == 2 and (c.captures, c.replays) == (1, 0) and not any(pk.launches.values())
    c.prepare("s", counting_stage(calls), x + 1, x)
    with c.eager():
        c.prepare("t", counting_stage(calls), x, x)
    assert len(calls) == 2 and c.stats()["graphs"] == 1
    (entry,) = c._graphs.values()
    assert torch.equal(c.call("s", counting_stage(calls), x, x), entry.output)  # a stub replay
    assert len(calls) == 2 and c.replays == 1 and pk.launches["lane_scan"] == 1


def test_prepare_runs_nothing_while_memory_is_short_and_its_call_stays_eager(stub_card):
    """Short of memory, `prepare` runs nothing and marks the key: its next
    call (after the collective) runs the stage eagerly and does not try to
    capture, even with the memory back. The next `prepare` captures."""
    c = cache.StageCache()
    calls = []
    x = torch.arange(4, dtype=torch.int32)
    stub_card["free"] = stub_card["limit"] - 1
    c.prepare("s", counting_stage(calls), x, x)
    assert not calls and (c.captures, c.uncaptured) == (0, 1)
    stub_card["free"] = stub_card["limit"]
    assert torch.equal(c.call("s", counting_stage(calls), x, x), 3 * x)
    assert len(calls) == 1 and c.captures == 0 and not c._graphs
    c.prepare("s", counting_stage(calls), x, x)
    assert len(calls) == 3 and c.captures == 1
    c.call("s", counting_stage(calls), x, x)
    assert len(calls) == 3 and c.replays == 1


@contextlib.contextmanager
def sharded_world_of_one(monkeypatch):
    """A gloo process group of one rank and a sharded call over two virtual
    shards of it, whose all-gathers, captures, card memory reads and
    combine and reduction runs are logged to the events it yields with
    the call."""
    import torch.distributed as dist

    from webgpu_msm_tpu_torch.parallel import msm_sharded

    events = []

    def logged(event, fn):
        return lambda *a, **k: events.append(event) or fn(*a, **k)

    monkeypatch.setattr(msm_sharded.dist, "all_gather", logged("all_gather", msm_sharded.dist.all_gather))
    monkeypatch.setattr(cache, "_capture", logged("capture", cache._capture))
    monkeypatch.setattr(cache, "_card_memory", logged("memory", cache._card_memory))
    monkeypatch.setattr(msm_sharded, "_combine", logged("combine", msm_sharded._combine))
    monkeypatch.setattr(msm_sharded, "_window_sums", logged("reduce", msm_sharded._window_sums))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    cache.clear()
    try:
        mesh = msm_sharded.Mesh((CPU, CPU), group=dist.group.WORLD)
        yield events, lambda mode: msm_sharded.msm_window_sums_sharded(
            torch.zeros((3, 16, 32), dtype=torch.int32), torch.zeros((8, 32), dtype=torch.int32),
            mesh=mesh, mode=mode, **STATIC)
    finally:
        cache.clear()
        dist.destroy_process_group()


def after_the_gather(events) -> list:
    return events[events.index("all_gather") + 1 :]


@pytest.mark.parametrize("mode", ["window_sums", "buckets"])
def test_sharded_captures_precede_the_all_gather(stub_card, mode, monkeypatch):
    """A rank of a process group (gloo, world 1, two virtual shards) takes
    every stage graph of a sharded call before it enters `dist.all_gather`:
    the combine's tree and buckets mode's reduction on stand-ins (the
    combine stage's `cache.prepare` calls), since a capture synchronizes
    the card. A second call captures nothing. Graphs are stubs here, so no
    result is read."""
    stub_card.update(limit=1 << 30, free=1 << 31)  # room for the sharded graphs
    with sharded_world_of_one(monkeypatch) as (events, sums):
        sums(mode)
        # acc, then reduce (window_sums) or the combine's tree and the reduction (buckets)
        assert events.count("capture") == 3 and after_the_gather(events) == []  # replays only
        assert cache.stats()["graphs"] == 3
        if mode == "window_sums":  # the tree's capture, on stand-ins, before the collective
            assert [k[0] for k in cache.CACHE._graphs][-1] == "sharded_combine_D2"
        events.clear()
        sums(mode)
        assert events == ["all_gather"] and cache.stats()["captures"] == 3


@pytest.mark.parametrize("mode", ["window_sums", "buckets"])
def test_sharded_stages_stay_eager_after_the_all_gather_while_memory_is_short(stub_card, mode, monkeypatch):
    """Short of memory, nothing is captured, the combine stage runs no
    stand-in before the all-gather, and after it only the stages themselves
    run, eagerly: no capture and no attempt at one. With the memory back,
    the next call captures every graph before the all-gather."""
    stub_card["free"] = stub_card["limit"] - 1
    after = ["combine"] if mode == "window_sums" else ["combine", "reduce"]
    with sharded_world_of_one(monkeypatch) as (events, sums):
        sums(mode)
        assert "capture" not in events and after_the_gather(events) == after
        assert events[: events.index("all_gather")].count("combine") == 0
        assert cache.stats()["captures"] == 0 and cache.stats()["uncaptured"] > 0
        stub_card.update(limit=1 << 30, free=1 << 31)
        events.clear()
        sums(mode)
        assert events.count("capture") == 3 and after_the_gather(events) == []


# ---------------------------------------------------------------------------
# the stage spans' outcomes and the eager count
# ---------------------------------------------------------------------------


def stage_spans(c, calls):
    """The labels of the stage spans that `calls` (each a function of the
    cache) record, and the cache's eager count after them."""
    trace.reset()
    for call in calls:
        call(c)
    return [label for label, _ in trace.records()], c.stats()["eager"]


def test_stage_spans_name_the_stage_and_its_outcome(stub_card):
    x = torch.arange(4, dtype=torch.int32)
    c = cache.StageCache()
    fn = counting_stage([])
    spans, eager = stage_spans(c, [lambda c: c.call("s", fn, x, x)] * 3)
    assert spans == ["stage s: capture", "stage s: replay", "stage s: replay"] and eager == 0
    assert (c.captures, c.replays) == (1, 2)


def eager_by_eager(c, stage, x, card):
    with c.eager():
        c.call("s", stage, x, x)


def eager_too_large(c, stage, x, card):
    card["limit"] = 2 * PER_GRAPH - 1
    c.call("s", stage, x, x)  # captured, then dropped: too large
    c.call("s", stage, x, x)


def eager_short_of_memory(c, stage, x, card):
    card["free"] = card["limit"] - 1
    c.call("s", stage, x, x)


def eager_unprepared(c, stage, x, card):
    free, card["free"] = card["free"], card["limit"] - 1
    c.prepare("s", stage, x, x)  # short of memory: the key is left uncaptured
    card["free"] = free
    c.call("s", stage, x, x)


@pytest.mark.parametrize("case, want", [
    (eager_by_eager, ["stage s: eager"]),
    (eager_too_large, ["stage s: capture", "stage s: eager"]),
    (eager_short_of_memory, ["stage s: eager"]),
    (eager_unprepared, ["stage s: eager"]),
], ids=["eager_mode", "too_large", "short_of_memory", "unprepared"])
def test_a_stage_run_without_a_graph_is_an_eager_span_and_counted(stub_card, case, want):
    x = torch.arange(4, dtype=torch.int32)
    c = cache.StageCache()
    spans, eager = stage_spans(c, [lambda c: case(c, counting_stage([]), x, stub_card)])
    assert spans == want and eager == want.count("stage s: eager") and c.replays == 0


def test_a_stage_on_the_cpu_is_an_eager_span_and_not_counted():
    """On the CPU there are no graphs: the span says `eager`, and the
    cache's counts, which are a card's, stay as they were."""
    c = cache.StageCache()
    x = torch.arange(4, dtype=torch.int32)
    spans, eager = stage_spans(c, [lambda c: c.call("cpu_stage", lambda a: a + 1, x)])
    assert spans == ["stage cpu_stage: eager"] and eager == 0 and c.stats()["captures"] == 0
