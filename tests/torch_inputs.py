"""Seeded inputs that several of the port's test files build alike."""
import numpy as np


def mont_window_sums(rng, K) -> np.ndarray:
    """Montgomery window sums [4, 16, K] uint32 below p, as `reduce_finish`
    writes them; lane 1 has z = 0, which the affine finish maps to (0, 0)."""
    d = rng.integers(0, 1 << 16, size=(4, 16, K), dtype=np.uint32)
    d[:, 15] %= 0x12AB  # p's top digit is 0x12ab
    d[3, :, 1] = 0
    return d
