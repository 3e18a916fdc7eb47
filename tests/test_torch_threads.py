"""The intra-op thread count of the port's test files.

Tier-1 runs the tests in six worker processes on the host's cores.  With
torch's default (one intra-op thread per core) in every worker, their
OpenMP threads oversubscribe the cores and wait on each other: six workers
each running a small model's train step took 713 s where two threads each
took 64 s (the same tests; a step alone takes 2 s).  A test file imports
:func:`few_torch_threads` (an autouse, module-scoped fixture) to run its
torch ops on TEST_THREADS threads.
"""

import pytest
import torch

#: torch's intra-op threads while a port test file runs
TEST_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """TEST_THREADS intra-op threads while the importing file runs; the
    previous count after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(threads)


def test_few_torch_threads_sets_the_count_while_a_file_runs():
    """This file's own tests run under the fixture: torch's intra-op
    threads are TEST_THREADS."""
    assert torch.get_num_threads() == TEST_THREADS
