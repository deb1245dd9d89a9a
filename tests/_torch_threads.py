"""One torch thread while a port test file runs.

The driver runs the tests in six worker processes on one host; each
worker's torch would otherwise start as many intra-op threads as the
host has cores, on top of JAX's own pool, and the port's small CPU
tensors gain nothing from them.  A test file imports the fixture (its
name in the module's namespace is enough for pytest), which restores the
worker's thread count when the file is done."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
