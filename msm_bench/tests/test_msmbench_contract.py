"""BENCHMARK.json against the benchmark's contract, the result line, and
what a run refuses: a checkout without the program, a process that has
loaded JAX or the JAX package, a machine without a card."""
import json
import re
import shutil
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

from msm_bench import harness, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["msm_bench"] and len(BENCH["command"]) <= 32
    assert all(LINE(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200  # with 24 cells
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert 1 <= cells <= 24 and (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE(c["source"]) and LINE(c["why"]) and c["file"].startswith("msm_bench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
        assert (ROOT / "msm_bench" / "entries" / f"{data['entry']}.py").exists()
        assert all(k in data.get("published", {}) for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and LINE(w["why"]) and NAME.match(w["traffic"])
        assert (ROOT / "msm_bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and LINE(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        assert (ROOT / "msm_bench" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        assert any(w in m["workloads"] for m in BENCH["per_layer"])


def _tiny(monkeypatch, **traffic):
    """load_cell with the cell's traffic cut to a CPU-sized mix."""
    real = harness.load_cell

    def load(name):
        cell, chips = real(name)
        cell.traffic = dict(cell.traffic, **traffic)
        return cell, chips

    monkeypatch.setattr(harness, "load_cell", load)
    monkeypatch.setattr(harness, "WARM_ROUNDS", 1)


def test_result_line(monkeypatch, capsys):
    _tiny(monkeypatch, points=[128], input_sets=1)
    assert run.main(["--workload", "web-msm.2p16", "--seed", str(2**31 + 9), "--seconds", "0",
                     "--trace", "0"], device="cpu") == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "msm_ms", "call_p95_ms"}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert err.strip().splitlines()[-3:] == [f"check {k}: 0 (limit 0)" for k in line["checks"]]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    assert run.main(["--workload", "web-msm.2p16", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_module_no_result(monkeypatch, capsys):
    _tiny(monkeypatch, points=[128], input_sets=1)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "web-msm.2p16", "--seed", "3", "--seconds", "0"], device="cpu") == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "webgpu_msm_tpu_torch_other", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]  # whole top-level names only


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "msm_bench", tmp_path / "msm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, *BENCH["command"][1:], "--workload", "web-msm.2p20", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "webgpu_msm_tpu_torch" in p.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of a cell's entry on the CPU, in a fresh process; then
    the reference alone loads nothing of the program."""
    script = textwrap.dedent("""
        import sys, time
        from msm_bench import harness
        cell, _ = harness.load_cell("fixed-base.2p20-single")
        cell.traffic = dict(cell.traffic, points=[128], input_sets=1)
        harness.WARM_ROUNDS = 1
        r = harness.run_cell(cell, 5, 0.0, False, "cpu", time.perf_counter())
        assert r["correct"], r
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    p = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    top = eval(p.stdout.strip().splitlines()[-1])
    assert "webgpu_msm_tpu_torch" in top
    assert not {"jax", "jaxlib", "flax", "webgpu_msm_tpu"} & set(top)
    script = ("import sys; import msm_bench.reference.inputs, msm_bench.reference.expected, "
              "msm_bench.reference.control_entry; print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=300)
    top = eval(p.stdout.strip().splitlines()[-1])
    assert not {"webgpu_msm_tpu_torch", "webgpu_msm_tpu", "jax", "jaxlib", "flax"} & set(top)
