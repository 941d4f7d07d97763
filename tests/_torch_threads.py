"""One intra-op torch thread for the port's CPU tests.

The plain versions of the kernels run many small tensor ops over few
lanes, where one thread is faster than many; and the suite runs in
parallel workers, which with a thread pool each would oversubscribe the
host's cores.  A test module takes the fixture by importing it:

    from _torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
