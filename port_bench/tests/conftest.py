"""The CPU tests run in several workers at once: one torch thread each."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
