"""One torch thread for each of the port's tests.

The tier-1 suite runs six xdist workers on one host, and torch sizes its
intra-op pool at one thread a core.  Beside the other workers those
pools oversubscribe the cores: each parallel op waits for its slowest
thread, so the port's tests ran slower than on one thread, and they took
the cores from every other worker, the one running the JAX package's long
`tests/test_sequence.py`, which sets the run's length, among them.

A port test file takes the fixture with

    from port_fixture import one_torch_thread  # noqa: F401

and each of its tests then runs with one intra-op thread, and with
OMP_NUM_THREADS=1 for the processes it starts.  A test that wants more
threads sets them itself; the fixture puts the count back afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)
