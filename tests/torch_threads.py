"""torch on one intra-op thread for a test module of the port.

The port's tests hold small tensors, and the suite runs under several
workers: torch's own intra-op threads would only contend with the other
workers'.  A test file takes the module-scoped autouse fixture with

    from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

and the thread count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
