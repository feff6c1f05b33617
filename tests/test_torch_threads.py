"""The intra-op thread cap shared by the port's CPU test files.

Each `tests/test_torch_*.py` file imports `two_torch_threads`, which makes
the fixture autouse for that file's tests.  The suite runs several pytest
workers at once; torch's default of one intra-op thread per core in each
of them oversubscribes the host.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_threads_capped_while_module_runs():
    assert torch.get_num_threads() == 2
