"""A module-scope fixture for the port's test modules: torch runs on one
intra-op thread while the module's tests run, and the count is restored
after. The test workers share the machine and the port's CPU tensors are
small, so more threads only contend. A bitwise check compares results made
in one process, so both of its sides run on the same thread count.

Use: ``from torch_threads import one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)
