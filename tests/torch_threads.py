"""One torch thread for the port's CPU tests.

pytest-xdist runs several test files at once, each worker with torch's
default pool of one thread a core.  A trace issues thousands of small
operations, and the pools' threads then contend for the cores with the
other workers: the same tests run several times slower in the suite than
alone.  A test module imports the autouse fixture below; it is module
scoped, so the module's own module-scoped fixtures run under it too.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
