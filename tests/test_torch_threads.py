"""One torch thread for the port's CPU test modules that import it.

The port's CPU paths run many small tensor ops.  Under the test runner's
parallel workers every core is busy, and an op that splits over several
threads waits for the slowest of them to be scheduled: the same module
took 356 s with torch's default threads on a loaded 8-core machine and
33 s with one.  The results do not depend on the thread count (integer
ops).  Import ``one_torch_thread`` into a test module to use it there.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
