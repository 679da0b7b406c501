"""The benchmark on the card: the input maker's limb arithmetic there,
and a traced run of a cell at a small size. Marked `gpu`; each test skips
without a card (decided inside the test).

    python -m pytest --noconftest -m gpu msm_bench/tests/test_msmbench_gpu.py
"""
import random
import time

import pytest
import torch

from msm_bench import harness
from msm_bench.reference import curve, expected, field, inputs

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_field_on_the_card(card):
    rng = random.Random(3)
    a = [rng.randrange(1, curve.P) for _ in range(1000)]
    b = [rng.randrange(curve.P) for _ in range(1000)]
    ma, mb = field.to_mont(a, card), field.to_mont(b, card)
    back = lambda t: field.from_limbs(field.from_mont(t))
    assert back(field.mont_mul(ma, mb)) == [x * y % curve.P for x, y in zip(a, b)]
    assert back(field.batch_inverse(ma)) == [pow(x, -1, curve.P) for x in a]


def test_inputs_on_the_card(card):
    made = inputs.make_inputs(2**31 + 1, [5000], 2, False, 253, card)
    for s in made.sets:
        assert expected.points_on_chain(made.k0, s, range(0, 5000, 50)) == 0
        assert len({bytes(r) for r in s.points}) == 5000


def test_traced_run(card):
    cell, _ = harness.load_cell("web-msm.2p16")
    cell.traffic = dict(cell.traffic, points=[1 << 14], input_sets=2)
    r = harness.run_cell(cell, 12, 0.5, True, card, time.perf_counter())
    assert r["correct"], r["checks"]
    assert {"host_lead_ms", "batch_stage_ms", "finish_stage_ms", "device_idle_share"} <= set(r["metrics"])
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
