"""``test_torch_spatial_zoo_step.py``'s checks at ``mesh_shape`` [2, 2]
for one 3D and one 2D model: four gloo ranks, two data indices of one row
each, two H slabs each.  AttentionUNet-3D (its gates' InstanceNorms at
C = 1 and 2 over the slabs) and MedFormer-2D (BatchNorm over the data and
spatial ranks, the B-MHA's and the semantic maps' softmaxes over the
slabs, the aux head's resize)."""

import pytest

from test_torch_spatial_step import check_loss
from test_torch_spatial_zoo_step import (CASES, check_zoo_gradient,
                                         check_zoo_trajectory, zoo_runs)
from test_torch_threads import few_torch_threads  # noqa: F401

CASES22 = {k: CASES[k] for k in ("attention_unet3d", "medformer2d")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return zoo_runs(tmp_path_factory.mktemp("spatial_zoo22"), [2, 2],
                    CASES22)


@pytest.mark.parametrize("case", CASES22)
def test_zoo_data_and_spatial_ranks_hold_the_global_loss(runs, case):
    check_loss(runs, case)


@pytest.mark.parametrize("case", CASES22)
def test_zoo_data_and_spatial_ranks_reduce_the_global_gradient(runs, case):
    check_zoo_gradient(runs, case)


@pytest.mark.parametrize("case", CASES22)
def test_zoo_data_and_spatial_ranks_follow_the_one_process_trajectory(
        runs, case):
    check_zoo_trajectory(runs, case)
