"""An autouse fixture for the port's CPU tests: one intra-op torch thread.

On the CPU the port's GRU runs as plain loops of thousands of tiny ops.
When several test workers share the machine, torch's intra-op thread
pool only makes each tiny op wait for threads that are not scheduled
(one resume test took 70 times longer than alone). Import the fixture
into a test module to apply it to every test there; the thread count is
restored afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
