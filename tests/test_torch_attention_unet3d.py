"""AttentionUNet-3D in the PyTorch port vs ``cbim_tpu``'s, on the CPU, with
the checks of ``tests/test_torch_unet3d.py``: the keys round-trip through
``import_attention_unet``, the eval forward (its blocks and the gates'
InstanceNorms on the kernel wrappers) and a 2-step trajectory match the
JAX model, the gate's eps is 1e-5, and every shipped recipe builds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models.attention_unet import AttentionGate as JaxGate
from cbim_tpu.models.attention_unet import AttentionUNet3D as JaxAttUNet3D
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import attention_unet, get_model
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.utils.jax_import import (
    _Walk, attention_unet3d_state_dict_from_jax)
from test_torch_swin_unetr import jax_params
from test_torch_unet3d import (ZOO, check_eval_forward, check_round_trip,
                               check_train)
from test_torch_threads import few_torch_threads  # noqa: F401

D = dict(ZOO, model="attention_unet")


def _case():
    jm = JaxAttUNet3D(num_classes=3, base_ch=4, block="BasicBlock",
                      norm="in")

    def to_jax(sd, template):
        return torch_import.import_attention_unet(sd, template,
                                                  block="BasicBlock")

    def to_sd(params):
        return attention_unet3d_state_dict_from_jax({"params": params},
                                                    config_from_dict(D))

    return D, jm, to_jax, to_sd


def test_keys_round_trip_through_import_attention_unet():
    check_round_trip(*_case())


def test_eval_forward_matches_jax(monkeypatch):
    """The tiny ResUNet's 42 kernel convs and norms, and three gate norms
    per up block (eps 1e-5, C = 4-32 and the psi map's C = 1)."""
    got = check_eval_forward(*_case(), monkeypatch)
    assert got == dict(conv3d=42, inorm=54, routed_conv=42, routed_norm=54)


def test_two_step_trajectory_matches_make_train_step():
    check_train(*_case())


def test_gate_eps_is_torch_default():
    """The gate's InstanceNorms take eps 1e-5, the blocks' 1e-4.  On inputs
    of about 3e-3, where eps and the projections' variance are of a size,
    the gate matches ``AttentionGate`` to 1e-4 relative, and the same gate
    at the blocks' eps would differ by percents."""
    model = get_model(config_from_dict(D), device="cpu")
    gate_eps = {m.eps for name, m in model.named_modules()
                if isinstance(m, convs.Norm) and ".attn." in name}
    block_eps = {m.eps for name, m in model.named_modules()
                 if isinstance(m, convs.Norm) and ".attn." not in name}
    assert gate_eps == {attention_unet.GATE_EPS} == {1e-5}
    assert block_eps == {1e-4}

    rng = np.random.default_rng(4)
    g = (3e-3 * rng.normal(size=(2, 4, 6, 6, 8))).astype(np.float32)
    x = (3e-3 * rng.normal(size=(2, 4, 6, 6, 4))).astype(np.float32)
    jg = JaxGate(int_ch=4)
    params = jax_params(jg, g.shape, seed=5, x=jnp.zeros(x.shape))
    ref = np.asarray(jg.apply({"params": params}, jnp.asarray(g),
                              jnp.asarray(x)))
    walk = _Walk(params)
    for c, name in enumerate(("W_g", "W_x", "psi")):
        walk.conv((f"Conv_{c}", "kernel"), f"{name}.0.weight")
    gate = attention_unet.AttentionGate(8, 4, 4)
    gate.load_state_dict(walk.state_dict())

    def run():
        with torch.inference_mode():
            return gate(torch.from_numpy(g).movedim(-1, 1),
                        torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)

    np.testing.assert_allclose(run().numpy(), ref, rtol=1e-4, atol=1e-8)
    for m in gate.modules():
        if isinstance(m, convs.Norm):
            m.eps = 1e-4
    err = np.abs(run().numpy() - ref) / np.abs(ref).max()
    assert float(err.max()) > 1e-2


ATT_RECIPES = ["acdc", "amos_ct", "amos_mr", "bcv", "kits", "lits"]


@pytest.mark.parametrize("dataset", ATT_RECIPES)
def test_shipped_recipes_build(dataset):
    """Each shipped AttentionUNet yaml (BasicBlock, base 32; KiTS and LiTS
    name their arch attention_resunet) builds with a gate of out_ch // 2
    channels at every up block."""
    pytest.importorskip("yaml")
    from cbim_tpu_torch.config import load_config
    cfg = load_config(dataset, "attention_unet", "3d")
    model = get_model(cfg, device="cpu")
    c = cfg.base_chan
    assert [getattr(model, f"up{i}").attn.W_g[0].out_channels
            for i in range(1, 5)] == [4 * c, 2 * c, c, c // 2]
    assert isinstance(model.up4.conv[0], convs.BasicBlock)
    assert model.outc.out_channels == cfg.classes
