"""The native row copier of the GPU engine's staging
(`webgpu_msm_tpu_torch/runtime/rows.py`, `runtime/csrc/row_copy.cpp`),
held byte for byte against `np.copyto`.

Both layouts (the x||y words of [n, 32] point rows, [n, 8] scalar rows
whole), n from 0 through the parallel bound to 2^18 + 3, with the pool
and with the caller alone; a source 4 bytes off a 32-byte boundary and a
destination that is not 32-byte aligned (plain stores); `_Staged.rows`
windows at odd offsets in any order, with the padding past n; and the
counter "batches staged in parallel", which counts only the writes the
pool shared.
"""
import numpy as np
import pytest
import torch

from webgpu_msm_tpu_torch.engines import gpu_engine
from webgpu_msm_tpu_torch.runtime import rows
from webgpu_msm_tpu_torch.utils import trace

from torch_threads import one_torch_thread  # noqa: F401  (one PyTorch CPU thread)

LAYOUTS = {"xy": (32, 16), "scalars": (8, 8)}  # source words a row, words copied
BOUND = rows.PARALLEL_ROWS
SIZES = [0, 1, BOUND - 1, BOUND, BOUND + 1, (1 << 18) + 3]
CPU = torch.device("cpu")


def source(n: int, words: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, size=(n, words), dtype=np.uint32)


def offset_rows(n: int, words: int, offset: int) -> np.ndarray:
    """[n, words] u32 rows whose first byte lies `offset` bytes past a
    32-byte boundary."""
    buf = np.empty(n * words + 16, np.uint32)
    skip = ((offset - buf.ctypes.data) % 32) // 4
    return buf[skip : skip + n * words].reshape(n, words)


@pytest.fixture
def clean_trace():
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("parallel", [True, False], ids=["pool", "alone"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_copy_equals_numpy(layout, n, parallel):
    src_words, words = LAYOUTS[layout]
    src = source(n, src_words, seed=n)
    dst = np.full((n, words), 0xDEADBEEF, np.uint32)
    want = np.empty_like(dst)
    np.copyto(want, src[:, :words])
    used = rows.copy_rows(dst, src, _parallel=parallel)
    assert dst.tobytes() == want.tobytes()
    # the pool takes part only where asked, with more than one chunk of rows
    # (256 KiB of destination) and more than one CPU to share them
    assert used == (parallel and n > 1 and rows.workers() > 0)


@pytest.mark.parametrize("parallel", [True, False], ids=["pool", "alone"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_misaligned_source_and_destination(layout, parallel):
    """A source 4 bytes off a 32-byte boundary (unaligned loads), into a
    destination that is 32-byte aligned (streaming stores) and into one
    that is not (the plain-store fallback)."""
    src_words, words = LAYOUTS[layout]
    n = BOUND + 5
    src = offset_rows(n, src_words, 4)
    src[:] = source(n, src_words, seed=7)
    want = src[:, :words].copy()
    for offset in (0, 4, 8):
        dst = offset_rows(n, words, offset)
        dst.fill(0)
        rows.copy_rows(dst, src, _parallel=parallel)
        assert dst.tobytes() == want.tobytes(), offset


def test_rejects_what_it_cannot_copy():
    src = source(8, 32)
    with pytest.raises(ValueError):
        rows.copy_rows(np.empty((8, 16), np.uint32), src[:, ::2])  # words not contiguous
    with pytest.raises(ValueError):
        rows.copy_rows(np.empty((8, 16), np.int32), src)
    with pytest.raises(ValueError):
        rows.copy_rows(np.empty((7, 16), np.uint32), src)
    with pytest.raises(ValueError):
        rows.copy_rows(np.empty((8, 40), np.uint32), src)
    with pytest.raises(ValueError):
        rows.copy_rows(np.empty((8, 32), np.uint32)[:, :16], src)  # destination rows not contiguous
    with pytest.raises(ValueError):
        rows.copy_rows(np.empty((8, 16), np.uint32), src.astype(">u4"))  # not native u32


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_staged_windows_at_odd_offsets_in_any_order(clean_trace, layout):
    """A job's buffer written in windows at odd offsets, in any order,
    across the parallel bound and past n, holds what `np.copyto` of the
    rows and the padding give; the counter counts the windows the pool
    shared, those of at least `PARALLEL_ROWS` source rows."""
    src_words, words = LAYOUTS[layout]
    n = 2 * BOUND + 3
    pad_to = n + 11
    src = source(n, src_words, seed=3)
    stage = gpu_engine._stage_xy if layout == "xy" else gpu_engine._stage_scalars
    staged = stage(src, pad_to, CPU)
    windows = [(BOUND + 1, n + 5), (0, 7), (n + 5, pad_to), (7, BOUND + 1)]
    for lo, hi in windows:
        staged.rows(lo, hi)
    want = np.empty((pad_to, words), np.uint32)
    np.copyto(want[:n], src[:, :words])
    want[n:] = staged.pad
    assert staged.array.tobytes() == want.tobytes()
    shared = sum(min(hi, n) - lo >= BOUND for lo, hi in windows) if rows.workers() > 0 else 0
    assert trace.counts()[trace.PARALLEL_BATCHES] == shared
    assert trace.counts()[trace.STAGED_BYTES] == pad_to * words * 4


def test_counter_counts_only_the_batches_the_pool_shared(clean_trace, monkeypatch):
    """Below the bound the caller copies alone and nothing is counted; at
    it the pool shares the write and each such write counts once; a pool
    that does not take part counts nothing."""
    src = source(BOUND, 32, seed=9)
    gpu_engine._stage_xy(src[: BOUND - 1], BOUND, CPU).rows(0, BOUND)
    assert trace.counts()[trace.PARALLEL_BATCHES] == 0
    staged = gpu_engine._stage_xy(src, 2 * BOUND, CPU)
    staged.rows(0, BOUND)
    staged.rows(BOUND, 2 * BOUND)  # all padding: no source rows to copy
    assert trace.counts()[trace.PARALLEL_BATCHES] == (1 if rows.workers() > 0 else 0)
    monkeypatch.setattr(rows, "PARALLEL_ROWS", 1 << 30)
    gpu_engine._stage_xy(src, BOUND, CPU).rows(0, BOUND)
    assert trace.counts()[trace.PARALLEL_BATCHES] == (1 if rows.workers() > 0 else 0)


def test_copies_from_many_threads_at_once():
    """Copies from several threads at once: one holds the pool, the others
    copy alone, and every copy is whole."""
    from concurrent.futures import ThreadPoolExecutor

    srcs = [source(BOUND + 9, 32, seed=s) for s in range(6)]
    dsts = [np.zeros((BOUND + 9, 16), np.uint32) for _ in srcs]
    with ThreadPoolExecutor(max_workers=6) as ex:
        futures = [ex.submit(rows.copy_rows, d, s, _parallel=True)
                   for _ in range(3) for d, s in zip(dsts, srcs)]
        for f in futures:
            f.result(timeout=120)
    for d, s in zip(dsts, srcs):
        assert d.tobytes() == np.ascontiguousarray(s[:, :16]).tobytes()
