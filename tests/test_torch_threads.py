"""One torch intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist workers on a few cores, and the
port's tensors in these tests are small (a few envs), so torch's intra-op
threads gain nothing and contend for the cores with the other workers (and
their JAX): a jvrc_walk training test of test_torch_slice.py took 32 s at 8
threads and 10 s at 1 on an 8-core host with two other busy processes.
``one_torch_thread`` sets one thread for a test module and restores the
count after it; a test module imports it, which makes it autouse there.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_torch_thread_holds_in_the_module():
    assert torch.get_num_threads() == 1
