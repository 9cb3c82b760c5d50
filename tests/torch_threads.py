"""One intra-op thread for the port's CPU tests.

The suite runs in several worker processes at once (``pytest -n``), and
each worker's PyTorch runs its CPU ops on a pool of as many threads as the
machine has cores: workers that run the port's small tensors at once then
spend most of their time waiting on one another's threads (under the
suite's six workers ``test_torch_data.py::test_feeds_lm_training``, 30
training steps of the xLSTM smoke config, took 137 s on the default pool
and 5.5 s on one thread).  A test file of the port imports
:func:`one_torch_thread`, which runs the file's tests on one intra-op
thread and restores the pool after them.  The tests' tolerances hold with
either pool.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
