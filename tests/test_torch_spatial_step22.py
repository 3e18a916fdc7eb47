"""``test_torch_spatial_step.py``'s checks at ``mesh_shape`` [2, 2]: four
gloo ranks, two data indices of one row each, two H slabs each."""

import pytest

from test_torch_spatial_step import (CASES, check_batchnorm_statistics,
                                     check_gradient, check_loss,
                                     check_trajectory, spatial_runs)
from test_torch_threads import few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spatial_runs(tmp_path_factory.mktemp("spatial22"), [2, 2])


@pytest.mark.parametrize("case", CASES)
def test_data_and_spatial_ranks_hold_the_global_loss(runs, case):
    check_loss(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_data_and_spatial_ranks_reduce_the_global_gradient(runs, case):
    check_gradient(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_data_and_spatial_ranks_follow_the_one_process_trajectory(runs,
                                                                  case):
    check_trajectory(runs, case)


def test_data_and_spatial_ranks_keep_the_global_batchnorm_statistics(runs):
    check_batchnorm_statistics(runs)
