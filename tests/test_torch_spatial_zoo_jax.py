"""H-sharded training of UNet++-3D, AttentionUNet-3D and VNet against the
JAX package: the port's first loss on two gloo ranks at ``mesh_shape``
[1, 2] equals the JAX package's train step on a [1, 2] ('data',
'spatial') mesh of two host devices (``test_torch_spatial_jax.py``'s
``jax_spatial_loss``: the image sharded on H, the Pallas kernels off),
within JAX_LOSS_RTOL, on the same weights (the port's seeded init carried
into Flax by ``torch_import.import_unetpp``, ``import_attention_unet``
and ``import_vnet``) and global batch.  VNet's channel dropout draws the
same masks on both sides (``test_torch_vnet.py``'s ``fix_dropout_masks``
in JAX; the ranks' ``ChannelDropout.keep_mask`` from the payload's
masks, each rank its data index's rows).

The 2D models: ``test_torch_spatial_zoo_jax2d.py``.
"""

import numpy as np
import pytest
import torch

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model, vnet
from test_torch_spatial_jax import JAX_LOSS_RTOL, MESH, jax_spatial_loss
from test_torch_spatial_step import batches
from test_torch_spatial_zoo_step import CASES as STEP_CASES
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401
from test_torch_vnet import DROPOUTS, _mask, fix_dropout_masks
import torch_dist_worker as worker

CASES = {k: STEP_CASES[k] for k in ("unetpp3d", "attention_unet3d", "vnet")}
#: the JAX importer of each case's state_dict into a params template
IMPORT = {
    "unetpp3d": lambda sd, t: torch_import.import_unetpp(
        sd, t, block="SingleConv"),
    "attention_unet3d": lambda sd, t: torch_import.import_attention_unet(
        sd, t, block="SingleConv"),
    "vnet": torch_import.import_vnet,
}


def vnet_masks(d, batch) -> list:
    """VNet's channel-dropout keep masks (batch, channels), in call order:
    ``test_torch_vnet.py``'s ``_mask`` at the channels of each of a
    forward's DROPOUTS calls (recorded from a forward of the port)."""
    channels = []
    real = vnet.ChannelDropout.keep_mask

    def record(self, x):
        channels.append(x.shape[1])
        return torch.ones(x.shape[:2] + (1,) * (x.dim() - 2), dtype=bool)

    vnet.ChannelDropout.keep_mask = record
    try:
        model = get_model(config_from_dict(d), device="cpu", train=True)
        with torch.no_grad():
            model(torch.zeros(batch, 1, *d["training_size"]))
    finally:
        vnet.ChannelDropout.keep_mask = real
    assert len(channels) == DROPOUTS, channels
    return [_mask(i, batch, c) for i, c in enumerate(channels)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the payload and the two ranks' runs (one launch)."""
    payloads = {}
    for name, d in CASES.items():
        model = get_model(config_from_dict(d), device="cpu",
                          generator=torch.Generator().manual_seed(1))
        img, lab = batches(d)[0]
        payloads[name] = dict(cfg=d, state_dict=model.state_dict(),
                              batches=[(img, lab)])
        if name == "vnet":
            payloads[name]["channel_masks"] = vnet_masks(d, img.shape[0])
    ranks = worker.launch("train_steps_many", 2,
                          str(tmp_path_factory.mktemp("spatial_zoo_jax")),
                          dict(runs=payloads, cfg=MESH))
    return {name: (p, [r[name] for r in ranks])
            for name, p in payloads.items()}


@pytest.mark.parametrize("case", CASES)
def test_zoo_spatial_loss_matches_the_jax_spatial_mesh(runs, case):
    payload, ranks = runs[case]
    d = CASES[case]
    img, lab = payload["batches"][0]
    jm = jax_get_model(jax_config(d))
    template = jax_params(jm, (1, *img.shape[1:]), seed=0)
    params = IMPORT[case](
        {k: v.numpy() for k, v in payload["state_dict"].items()}, template)
    with pytest.MonkeyPatch.context() as mp:
        if case == "vnet":
            fix_dropout_masks(mp)
            jm = jax_get_model(jax_config(d))      # its nn.Dropout fixed
        loss = jax_spatial_loss(d, params, img, lab, model=jm)
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], loss, rtol=JAX_LOSS_RTOL)
