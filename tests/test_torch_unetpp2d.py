"""UNet++-2D in the PyTorch port vs ``cbim_tpu``'s, on the CPU, with the
2D zoo's checks (``test_torch_unet2d``): the keys through
``import_unetpp`` and back (BatchNorm included), the eval softmax with
perturbed BatchNorm statistics, the step-0 gradients against
``make_train_step``'s.  The first stage's first conv reads the 1-channel
input: on the card it takes the CUDA-core route of the 3x3 conv kernel,
the rest the 3xTF32 one.
"""

import pytest
import torch

from cbim_tpu.models.unetpp import UNetPlusPlus2D as JaxUNetPlusPlus2D
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.ops.kernels.conv2d import conv2d_route
from cbim_tpu_torch.ops.kernels.conv3d import CUDA_CORE, TF32X3
from cbim_tpu_torch.utils.jax_import import unetpp2d_state_dict_from_jax
from test_torch_unet2d import (ZOO2D, check_eval_forward, check_round_trip,
                               check_step_grads, few_torch_threads,
                               port_variables)  # noqa: F401

D = dict(ZOO2D, model="unet++")


@pytest.fixture(scope="module")
def case():
    jm = JaxUNetPlusPlus2D(num_classes=4, base_ch=8)

    def to_jax(sd, tmpl):
        return torch_import.import_unetpp(sd, tmpl, block="SingleConv")

    return D, jm, to_jax, unetpp2d_state_dict_from_jax


@pytest.fixture(scope="module")
def variables(case):
    return port_variables(case, 1)


def test_keys_round_trip_through_import_unetpp(case):
    check_round_trip(case)


def test_eval_forward_matches_jax(case, variables, monkeypatch):
    """All 30 ConvNormActs (15 stages of two SingleConvs; widths <= 192)
    on the 3x3 route: one wrapper call each a forward."""
    got = check_eval_forward(case, variables, monkeypatch)
    assert got == dict(conv2d=30, inorm=0, routed_conv=30, routed_norm=0)


def test_step_gradients_match_jax(case, variables):
    check_step_grads(case, variables)


def test_one_channel_conv_takes_the_cuda_core_route():
    """In fp32 on the card: conv0_0's first conv (1 -> 8) the CUDA-core
    kernel, every other routed conv the 3xTF32 one."""
    model = get_model(config_from_dict(D), device="cpu")
    routes = {name: conv2d_route(torch.float32, m.conv.in_channels,
                                 m.conv.out_channels)
              for name, m in model.named_modules()
              if isinstance(m, convs.ConvNormAct) and m.kernel is not None}
    assert routes.pop("conv0_0.0.conv") == CUDA_CORE
    assert set(routes.values()) == {TF32X3}
