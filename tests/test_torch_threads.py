"""One torch intra-op thread for the port's CPU tests, and its test.

The tier-1 suite runs six pytest processes on the CPU at once. A torch
op large enough to split runs on torch's OpenMP pool (a thread per core
by default), and its barrier then waits on threads that the other
processes hold: on an 8-core CPU, six concurrent runs of two LeNet-5
harness tests took 26 s at one thread and had not ended after 600 s at
eight. Each port test module imports this autouse fixture; the thread
count comes back after the module.
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_port_modules_run_on_one_thread():
    assert torch.get_num_threads() == 1
