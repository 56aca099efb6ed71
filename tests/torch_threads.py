"""`few_threads`, a module fixture for the CPU tests whose towers or FID
`eigh`s are heavy: a test file takes it with
`from tests.torch_threads import few_threads  # noqa: F401`."""

import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """torch and numpy's BLAS on two threads each, restored after: beside the
    suite's other workers, eight threads each oversubscribe the cores, and a
    2048 x 2048 `eigh` (FID's) or a tower's convolutions then take minutes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            yield
    finally:
        torch.set_num_threads(saved)
