"""H-sharded training of MedFormer-3D against the JAX package: the
port's loss on two gloo ranks at ``mesh_shape`` [1, 2] equals the JAX
package's train step on a [1, 2] ('data', 'spatial') mesh of two host
devices, jitted as ``cbim_tpu/training/trainer.py:57-95`` jits it, on the
same weights and global batch.

The JAX factory builds MedFormer-3D at the full stage widths only (it
passes no ``chan_num``), so the narrow model of
``test_torch_spatial_step.py`` (remat, deep supervision) is built from the
JAX module class directly; its Flax params, drawn with numpy, reach the
port through ``medformer3d_state_dict_from_jax``.
"""

import numpy as np
import pytest
import torch

from cbim_tpu.models.medformer import MedFormer3D as JaxMedFormer3D
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.utils.jax_import import medformer3d_state_dict_from_jax
from test_torch_spatial_jax import JAX_LOSS_RTOL, MESH, jax_spatial_loss
from test_torch_spatial_step import MEDFORMER, batches
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401
import torch_dist_worker as worker


def jax_medformer(d):
    """The JAX package's MedFormer-3D of config ``d`` (its own stage
    widths)."""
    return JaxMedFormer3D(
        num_classes=d["classes"], base_ch=d["base_chan"],
        chan_num=tuple(d["chan_num"]), map_size=tuple(d["map_size"]),
        conv_block=d["conv_block"], conv_num=tuple(d["conv_num"]),
        trans_num=tuple(d["trans_num"]), num_heads=tuple(d["num_heads"]),
        fusion_depth=d["fusion_depth"], fusion_dim=d["fusion_dim"],
        fusion_heads=d["fusion_heads"], expansion=d["expansion"],
        proj_type=d["proj_type"], norm=d["norm"], act=d["act"],
        kernel_size=tuple(map(tuple, d["kernel_size"])),
        scale=tuple(map(tuple, d["down_scale"])), aux_loss=d["aux_loss"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the JAX params, the global batch, the two ranks' runs)."""
    d = MEDFORMER
    img, lab = batches(d)[0]
    jm = jax_medformer(d)
    params = jax_params(jm, (1, *img.shape[1:]), seed=0, train=False)
    state_dict = {k: torch.from_numpy(np.asarray(v)) for k, v in
                  medformer3d_state_dict_from_jax(
                      params, config_from_dict(d)).items()}
    payload = dict(cfg=d, state_dict=state_dict, batches=[(img, lab)])
    ranks = worker.launch("train_steps_many", 2,
                          str(tmp_path_factory.mktemp("spatial_jax_mf")),
                          dict(runs={"medformer": payload}, cfg=MESH))
    return jm, params, img, lab, [r["medformer"] for r in ranks]


def test_spatial_medformer_loss_matches_the_jax_spatial_mesh(run):
    jm, params, img, lab, ranks = run
    loss = jax_spatial_loss(MEDFORMER, params, img, lab, model=jm)
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], loss, rtol=JAX_LOSS_RTOL)
