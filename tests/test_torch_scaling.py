"""The port's scaling model (`webgpu_msm_tpu_torch/parallel/scaling.py`):
the four cases of `tests/test_scaling.py` on the port's `payload_bytes` and
`modeled_efficiency` (its link rate is the H100 SXM's NVLink 4 figure, so
the efficiencies are its own), and the payloads equal to the JAX
package's for the same window, digit form and mode.
"""
import pytest

from webgpu_msm_tpu.parallel import scaling as jscaling

from webgpu_msm_tpu_torch.ops import pippenger, windows
from webgpu_msm_tpu_torch.parallel import scaling

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)


def test_payload_bytes_window_sums():
    # w=13: K = ceil(256/13) = 20 windows; [4,16] int32 planes per point
    assert windows.n_windows(13) == 20
    assert scaling.payload_bytes(13, True, "window_sums") == 20 * 4 * 16 * 4


def test_payload_bytes_buckets_mode_scales_with_B():
    B = pippenger.n_buckets(13, True)
    assert scaling.payload_bytes(13, True, "buckets") == 20 * B * 4 * 16 * 4
    assert scaling.payload_bytes(13, True, "buckets") > 1e6  # MB-class


def test_modeled_efficiency_bounds():
    pl = scaling.payload_bytes(13, True, "window_sums")
    assert scaling.modeled_efficiency(0.48, pl, 1) == 1.0
    for d in (2, 4, 8, 64):
        e = scaling.modeled_efficiency(0.48, pl, d)
        assert 0.0 < e <= 1.0
        assert e > 0.99  # tiny window-sums payload vs 0.48 s compute: near-linear


def test_modeled_efficiency_degrades_with_payload():
    pl_ws = scaling.payload_bytes(13, True, "window_sums")
    pl_bk = scaling.payload_bytes(13, True, "buckets")
    e_ws = scaling.modeled_efficiency(0.48, pl_ws, 8)
    e_bk = scaling.modeled_efficiency(0.48, pl_bk, 8)
    assert e_bk < e_ws
    assert e_bk > 0.8


@pytest.mark.parametrize("mode", ["window_sums", "buckets"])
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("w", [8, 13, 16])
def test_payload_equals_jax(w, signed, mode):
    assert scaling.POINT_COORD_BYTES == jscaling.POINT_COORD_BYTES
    assert scaling.payload_bytes(w, signed, mode) == jscaling.payload_bytes(w, signed, mode)


def test_link_rate_is_the_nvlink_figure():
    """450 GB/s each way: gathering 450 MB from one peer takes 1 ms."""
    assert scaling.NVLINK_BYTES_PER_S == 450e9
    assert scaling.modeled_efficiency(1e-3, int(450e6), 2) == pytest.approx(0.5)
