"""One PyTorch intra-op thread for each of the port's test files.

The port's CPU tests run tiny tensors, which gain nothing from PyTorch's
OpenMP threads, and the tier-1 run shares the machine's cores among
several pytest workers: one thread per file keeps each file from spinning
at OpenMP barriers that wait on threads the other workers hold.  Each file
imports :func:`one_torch_thread`, a module-scoped autouse fixture, and the
thread count is restored when the file's tests are done, so files of the
JAX package that share the worker run as before.
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
