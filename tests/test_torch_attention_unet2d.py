"""AttentionUNet-2D in the PyTorch port vs ``cbim_tpu``'s, on the CPU,
with the 2D zoo's checks (``test_torch_unet2d``): the keys through
``import_attention_unet(dimension="2d")`` and back (BatchNorm included,
no ``conv_ch``), the eval softmax with perturbed BatchNorm statistics, the
step-0 gradients against ``make_train_step``'s.  The gates' three
InstanceNorms a level (C = out / 2 twice and C = 1, eps 1e-5) run on the
fused norm kernels' wrapper on 2D tensors.
"""

import pytest

from cbim_tpu.models.attention_unet import AttentionUNet2D as JaxAttUNet2D
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.attention_unet import GATE_EPS
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.utils.jax_import import \
    attention_unet2d_state_dict_from_jax
from test_torch_unet2d import (ZOO2D, check_eval_forward, check_round_trip,
                               check_step_grads, few_torch_threads,
                               port_variables)  # noqa: F401

D = dict(ZOO2D, model="attention_unet")


@pytest.fixture(scope="module")
def case():
    jm = JaxAttUNet2D(num_classes=4, base_ch=8)

    def to_jax(sd, tmpl):
        return torch_import.import_attention_unet(
            sd, tmpl, block="SingleConv", dimension="2d")

    return D, jm, to_jax, attention_unet2d_state_dict_from_jax


@pytest.fixture(scope="module")
def variables(case):
    return port_variables(case, 1)


def test_keys_round_trip_through_import_attention_unet(case):
    check_round_trip(case)


def test_eval_forward_matches_jax(case, variables, monkeypatch):
    """17 SingleConvs on the 3x3 route and 12 gate InstanceNorms (3 a
    level), one wrapper call each a forward."""
    got = check_eval_forward(case, variables, monkeypatch)
    assert got == dict(conv2d=17, inorm=12, routed_conv=17, routed_norm=12)


def test_step_gradients_match_jax(case, variables):
    check_step_grads(case, variables)


def test_gate_norms_are_2d_instance_norms_down_to_one_channel():
    """Each gate: W_g and W_x to out / 2 channels and psi to 1, each a 1x1
    Conv2d without bias and an affine-free InstanceNorm at eps 1e-5; the
    blocks' BatchNorms at the 2D ConvNormAct's 1e-5; no ``conv_ch``."""
    model = get_model(config_from_dict(D), device="cpu")
    for i, out in enumerate((64, 32, 16, 8)):
        gate = getattr(model, f"up{i + 1}").attn
        widths = [(s[0].out_channels, s[0].kernel_size, s[1].kind, s[1].eps)
                  for s in (gate.W_g, gate.W_x, gate.psi)]
        assert widths == [(out // 2, (1, 1), "in", GATE_EPS)] * 2 + [
            (1, (1, 1), "in", GATE_EPS)]
        assert not hasattr(getattr(model, f"up{i + 1}"), "conv_ch")
    assert {m.eps for m in model.modules()
            if isinstance(m, convs.Norm) and m.kind == "bn"} == {1e-5}
