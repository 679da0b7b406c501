"""PyTorch's CPU thread count for the port's test files.

Their tensors are small, so extra intra-op threads only contend with the
other test workers. Each file imports `one_torch_thread`, which sets one
thread as the file starts (autouse and module-scoped, so it runs before
the file's other fixtures): the native CPU engine of either package shares
PyTorch's OpenMP runtime, and a file that ran before on the same worker
may have left that runtime with a thread a core.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    torch.set_num_threads(1)
