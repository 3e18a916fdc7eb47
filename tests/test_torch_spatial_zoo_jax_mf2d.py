"""``test_torch_spatial_zoo_jax2d.py``'s check for AttentionUNet-2D (its
gates' InstanceNorms over the slabs beside BatchNorm blocks) and
MedFormer-2D (B-MHA, semantic maps, deep supervision): the port's first
loss on two gloo ranks at ``mesh_shape`` [1, 2] within JAX_LOSS_RTOL of
the JAX package's step on a [1, 2] ('data', 'spatial') mesh, on the
weights ``import_attention_unet(dimension="2d")`` and
``import_medformer2d`` carry."""

import pytest

from test_torch_spatial_zoo_jax2d import check_jax_loss, rank_runs
from test_torch_spatial_zoo_step import CASES as STEP_CASES
from test_torch_threads import few_torch_threads  # noqa: F401

CASES = {k: STEP_CASES[k] for k in ("attention_unet2d", "medformer2d")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return rank_runs(tmp_path_factory.mktemp("spatial_zoo_jax_mf2d"), CASES)


@pytest.mark.parametrize("case", CASES)
def test_zoo2d_attention_spatial_loss_matches_the_jax_spatial_mesh(runs,
                                                                   case):
    check_jax_loss(runs, case)
