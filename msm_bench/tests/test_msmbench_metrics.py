"""The metric arithmetic: end-to-end numbers, the trace reductions on a
synthetic trace, and the frozen operation counts against chip_smoke.py's
bound() at the kernel table's three shapes."""
import importlib.util
from pathlib import Path

import pytest
import torch

from msm_bench import harness, trace_reader, yardstick
from msm_bench.trace_reader import DeviceRecord, HostRange, Trace

ROOT = Path(__file__).resolve().parents[2]
METRICS = ROOT / "msm_bench" / "metrics"


def metric(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_metric_{name}")


def test_msm_ms_counts_jobs_and_p95_takes_every_call():
    # 20 calls of 4 jobs, latencies 10..29 ms: p95 is between the 19th and 20th
    calls = [(0, i, i + (10 + i) / 1e3, [(0, 1)] * 4) for i in range(20)]
    v = harness.end_to_end_values(calls, 2.0, 7.5)
    assert v["msm_ms"] == pytest.approx(2000 / 80)
    assert v["call_p95_ms"] == pytest.approx(28.05)  # 10 + 0.95 * 19 ms, linear
    assert v["setup_s"] == 7.5


def _trace(**kw):
    """Two calls of 2 MSMs each over [0, 100] and [100, 200] us."""
    base = dict(
        calls=[(0.0, 100.0, 2), (100.0, 200.0, 2)],
        device=[DeviceRecord("Memcpy HtoD (Pinned -> Device)", 30.0, 40.0),
                DeviceRecord("accumulate_scan_gather_kernel", 40.0, 60.0),
                DeviceRecord("reduce_finish_kernel", 55.0, 70.0),
                DeviceRecord("Memcpy HtoD (Pinned -> Device)", 110.0, 120.0),
                DeviceRecord("accumulate_scan_gather_kernel", 120.0, 140.0),
                DeviceRecord("void at::native::sort_kernel<int>", 140.0, 150.0)],
        host=[HostRange("msm_bench.call", 0.0, 100.0), HostRange("phase: slice/pad inputs (wire)", 5.0, 25.0),
              HostRange("aten::copy_", 10.0, 20.0), HostRange("msm_bench.call", 100.0, 200.0),
              HostRange("cudaStreamSynchronize", 150.0, 200.0)],
        runtime_calls=12, phases={"slice/pad inputs (wire)": [2.0, 4.0]},
        launches={"accumulate_scan_gather": 4, "reduce_finish": 1},
        shape=yardstick.pipeline_shape(1 << 20, (13, 2048, 128)), mad_rate=1e13)
    base.update(kw)
    return Trace(**base)


def test_busy_union_idle_share_and_gaps():
    tr = _trace()
    assert trace_reader.busy_intervals(tr) == [[30.0, 70.0], [110.0, 150.0]]
    assert metric("device_idle_share").read(tr) == pytest.approx(100 * (1 - 80 / 200))
    assert trace_reader.idle_gaps(tr) == [(0.0, 30.0), (70.0, 110.0), (150.0, 200.0)]
    b = trace_reader.breakdown(tr)
    assert b["device_ops"][0] == ["accumulate_scan_gather_kernel", pytest.approx(40e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["msm_bench.call > phase: slice/pad inputs (wire) > aten::copy_"] == pytest.approx(30e-6)
    assert gaps["msm_bench.call > cudaStreamSynchronize"] == pytest.approx(50e-6)
    assert gaps["msm_bench.call"] == pytest.approx(40e-6)


def test_readers():
    tr = _trace()
    assert metric("host_lead_ms").read(tr) == pytest.approx((30 + 10) / 2 / 1e3)
    assert metric("stage_inputs_ms").read(tr) == pytest.approx(3.0)
    assert metric("host_calls_per_msm").read(tr) == pytest.approx(3.0)
    # the scan: 2 records of 20 us, 4 launches counted -> 80 us; sort 10 us
    assert metric("batch_stage_ms").read(tr) == pytest.approx((80 + 10) / 1e3 / 4)
    assert metric("finish_stage_ms").read(tr) == pytest.approx(15 / 1e3 / 4)
    least = yardstick.least_ms(yardstick.scan_products(tr.shape), 1e13) * 4
    assert metric("accumulate_scan_gather_roofline").read(tr) == pytest.approx(100 * least / 0.080)
    assert metric("grouped_running_sum_roofline").read(tr) is None  # no record: nothing to read


def test_readers_find_nothing_on_an_empty_trace():
    tr = _trace(device=[], phases={}, mad_rate=None, launches={})
    for f in METRICS.glob("*.py"):
        assert metric(f.stem).read(tr) is None, f.stem


def test_symbol():
    assert trace_reader.symbol("reduce_finish_kernel") == "reduce_finish_kernel"
    assert trace_reader.symbol("lane_scan_kernel(int const*, int)") == "lane_scan_kernel"
    assert trace_reader.symbol("void at::native::(anonymous namespace)::f<int>(int)").startswith("void at::")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# The kernel table's three shapes: the wire call (w 13, C 2048 x L 128 a
# batch of 2^18, four batches), the resident call (w 16, C 2048 x L 512,
# one batch), and the reduction at Gs 4 over the resident buckets.
@pytest.mark.parametrize("label, wire_plan, batches", [("wire", (13, 2048, 128), 4),
                                                       ("resident", (16, 2048, 512), 1)])
def test_counts_equal_chip_smoke_bound(label, wire_plan, batches):
    cs = _chip_smoke()
    rate = 1.6e13
    s = yardstick.pipeline_shape(1 << 20, wire_plan)
    assert (s["K"], s["B"]) == {"wire": (20, 4128), "resident": (16, 32800)}[label]
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
    scan, by = cs.bound("accumulate_scan_gather", (None, None, meta(s["L"], s["K"] * s["C"]), s["K"], s["B"]), rate)
    assert by == "operations"
    assert batches * scan == pytest.approx(yardstick.least_ms(yardstick.scan_products(s), rate))
    W = s["K"] * s["G"]
    grs, by = cs.bound("grouped_running_sum", (meta(s["Gs"], 4, 16, W),), rate)
    assert by == "operations"
    assert grs == pytest.approx(yardstick.least_ms(yardstick.grouped_running_sum_products(s), rate))
    rf, by = cs.bound("reduce_finish", (meta(4, 16, W), meta(4, 16, W), s["K"], s["doublings"]), rate)
    assert by == "operations"
    assert rf == pytest.approx(yardstick.least_ms(yardstick.reduce_finish_products(s), rate))


def test_counts_equal_chip_smoke_bound_at_gs4():
    cs = _chip_smoke()
    rate = 1.6e13
    s = dict(yardstick.pipeline_shape(1 << 20, (16, 2048, 512)), Gs=4, G=8200, doublings=2)
    W = s["K"] * s["G"]
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
    assert cs.bound("grouped_running_sum", (meta(4, 4, 16, W),), rate)[0] == pytest.approx(
        yardstick.least_ms(yardstick.grouped_running_sum_products(s), rate))
    assert cs.bound("reduce_finish", (meta(4, 16, W), meta(4, 16, W), 16, 2), rate)[0] == pytest.approx(
        yardstick.least_ms(yardstick.reduce_finish_products(s), rate))


def test_pipeline_shape_follows_the_program():
    from webgpu_msm_tpu_torch import MSMConfig
    from webgpu_msm_tpu_torch.engines import gpu_engine
    from webgpu_msm_tpu_torch.ops import pippenger, windows

    for n in (1 << 16, 1 << 20, 3000):
        cfg = MSMConfig()
        s = yardstick.pipeline_shape(n, cfg.resolved_wire_plan(n))
        assert s["K"] == windows.n_windows(s["w"])
        assert s["B"] == pippenger.n_buckets(s["w"], True)
        assert s["Gs"] == pippenger.group_size(s["B"])
        assert s["pad_to"] == gpu_engine._padded_plan(cfg, n)[3]


def test_long_gaps_are_split_by_what_the_host_did():
    tr = _trace(calls=[(0.0, 1000.0, 1)], device=[DeviceRecord("k", 900.0, 1000.0)],
                host=[HostRange("msm_bench.call", 0.0, 1000.0), HostRange("phase: a", 0.0, 600.0)])
    gaps = dict((k, v) for k, v in trace_reader.breakdown(tr)["idle_gaps"])
    assert gaps == {"msm_bench.call > phase: a": pytest.approx(600e-6),
                    "msm_bench.call": pytest.approx(300e-6)}


def test_short_name():
    assert trace_reader.short_name("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int, 4>(char*)") \
        == "at::native::CatArrayBatchedCopy"
    assert trace_reader.short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD (Pinned -> Device)"
