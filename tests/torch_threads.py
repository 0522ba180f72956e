"""One torch intra-op thread for a test module of the port.

    from tests.torch_threads import one_torch_thread  # noqa: F401

The tiny rigs' ops are too small to share between threads, and under
pytest-xdist's workers torch's default of a thread per core oversubscribes
the host: the recipe chain ran about ten times slower beside six busy
workers. The fixture is module-scoped and autouse, and restores the count
afterwards.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
