"""H-sharded training of the 2D CNN models against the JAX package:
UNet-2D, ResUNet-2D and UNet++-2D here (AttentionUNet-2D and MedFormer-2D:
``test_torch_spatial_zoo_jax_mf2d.py``), the port's first loss on two
gloo ranks at ``mesh_shape`` [1, 2] against the JAX package's train step
on a [1, 2] ('data', 'spatial') mesh of two host devices with the image
sharded P('data', 'spatial', None, None), as its trainer shards a 2D
batch (``test_torch_spatial_jax.py``'s
``jax_spatial_loss``), within JAX_LOSS_RTOL.

The weights are the port's seeded init carried into Flax by
``torch_import.import_unet(dimension="2d")``, ``import_unetpp``,
``import_attention_unet(dimension="2d")`` and ``import_medformer2d``, into
a template whose BatchNorms hold Flax's initial values (scale 1, bias 0,
mean 0, variance 1).  ``import_unet`` leaves the 2D BatchNorms at the
template's values (ROADMAP C15); this test relies on both packages
starting them at those values, as the port's init does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from test_torch_spatial_jax import JAX_LOSS_RTOL, MESH, jax_spatial_loss
from test_torch_spatial_step import batches
from test_torch_spatial_zoo_step import CASES as STEP_CASES
from test_torch_threads import few_torch_threads  # noqa: F401
import torch_dist_worker as worker

CASES = {k: STEP_CASES[k] for k in ("unet2d", "resunet2d", "unetpp2d")}


def _import(case, d, sd, variables):
    """Flax variables of the port's state_dict ``sd`` (numpy)."""
    if case in ("unet2d", "resunet2d"):
        return {"params": torch_import.import_unet(
                    sd, variables["params"], block=d["block"],
                    dimension="2d"),
                "batch_stats": variables["batch_stats"]}
    if case == "unetpp2d":
        return torch_import.import_unetpp(sd, variables, block="SingleConv")
    if case == "attention_unet2d":
        return torch_import.import_attention_unet(
            sd, variables, block="SingleConv", dimension="2d")
    return torch_import.import_medformer2d(
        sd, variables, d["conv_num"], d["trans_num"], d["num_heads"],
        d["base_chan"], d["fusion_depth"], d["fusion_heads"], d["aux_loss"])


def initial_variables(jm, shape) -> dict:
    """Flax variables of ``jm`` for inputs (B, H, W), as numpy: Flax's
    initial BatchNorm values (scale and variance 1, the rest 0) and zeros
    elsewhere, which the importers overwrite (shapes only: no compile)."""
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(
            lambda k, x: jm.init({"params": k}, x, train=False),
            jax.random.PRNGKey(0), jax.ShapeDtypeStruct((*shape, 1),
                                                        jnp.float32))

    def fill(path, s):
        one = path[-1].key in ("scale", "var")
        return (np.ones if one else np.zeros)(s.shape, s.dtype)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def rank_runs(tmp, cases) -> dict:
    """Per case of ``cases``: the payload and the two ranks' runs (one
    launch)."""
    payloads = {}
    for name, d in cases.items():
        model = get_model(config_from_dict(d), device="cpu",
                          generator=torch.Generator().manual_seed(1))
        payloads[name] = dict(cfg=d, state_dict=model.state_dict(),
                              batches=batches(d)[:1])
    ranks = worker.launch("train_steps_many", 2, str(tmp),
                          dict(runs=payloads, cfg=MESH))
    return {name: (p, [r[name] for r in ranks])
            for name, p in payloads.items()}


def check_jax_loss(runs, case):
    """Every rank's first loss within JAX_LOSS_RTOL of the JAX spatial
    mesh's on the imported weights."""
    payload, ranks = runs[case]
    d = STEP_CASES[case]
    img, lab = payload["batches"][0]
    jm = jax_get_model(jax_config(d))
    sd = {k: v.numpy() for k, v in payload["state_dict"].items()}
    variables = _import(case, d, sd, initial_variables(jm, img.shape[:3]))
    loss = jax_spatial_loss(d, variables["params"], img, lab, model=jm,
                            batch_stats=variables["batch_stats"])
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], loss, rtol=JAX_LOSS_RTOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return rank_runs(tmp_path_factory.mktemp("spatial_zoo_jax2d"), CASES)


@pytest.mark.parametrize("case", CASES)
def test_zoo2d_spatial_loss_matches_the_jax_spatial_mesh(runs, case):
    check_jax_loss(runs, case)
