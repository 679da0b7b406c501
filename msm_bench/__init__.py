"""The benchmark of the PyTorch and CUDA port `webgpu_msm_tpu_torch`.

    python3 -m msm_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` once and prints one JSON result line.
Cells, configurations, traffic mixes, call entries and per-layer metrics
are files of their own, found by name (see `harness.py`).
"""
