"""UNet++-3D in the PyTorch port vs ``cbim_tpu``'s, on the CPU, with the
checks of ``tests/test_torch_unet3d.py``: the keys round-trip through
``import_unetpp`` (the Flax stages in forward-call order), the eval forward
(every block on the kernel wrappers) and a 2-step trajectory match the JAX
model, and the shipped recipe builds with its nested dense skips.
"""

import pytest

from cbim_tpu.models.unetpp import UNetPlusPlus3D as JaxUNetPP3D
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.utils.jax_import import (UNETPP_ORDER,
                                             unetpp3d_state_dict_from_jax)
from test_torch_unet3d import (ZOO, check_eval_forward, check_round_trip,
                               check_train)
from test_torch_threads import few_torch_threads  # noqa: F401

D = dict(ZOO, model="unet++")


def _case():
    jm = JaxUNetPP3D(num_classes=3, base_ch=4, block="BasicBlock",
                     norm="in")

    def to_jax(sd, template):
        return torch_import.import_unetpp(sd, template, block="BasicBlock")

    def to_sd(params):
        return unetpp3d_state_dict_from_jax({"params": params},
                                            config_from_dict(D))

    return D, jm, to_jax, to_sd


def test_keys_round_trip_through_import_unetpp():
    check_round_trip(*_case())


def test_eval_forward_matches_jax(monkeypatch):
    """15 stages of two BasicBlocks: 60 preact convs and 15 shortcuts
    (each stage's first block takes a concatenation, a pooled coarser map
    or the input, of another width), all on the kernel route."""
    got = check_eval_forward(*_case(), monkeypatch)
    assert got == dict(conv3d=75, inorm=75, routed_conv=75, routed_norm=75)


def test_two_step_trajectory_matches_make_train_step():
    check_train(*_case())


def test_dense_skip_widths():
    """x_{i,j} takes j maps of row i and the upsampled x_{i+1,j-1}: its
    first block's input width is j * n_i + n_{i+1} (column 0: the pooled
    row above, or the input), the reference's grid."""
    model = get_model(config_from_dict(D), device="cpu")
    n = [4, 8, 16, 32, 40]
    for name in UNETPP_ORDER:
        i, j = map(int, name[4:].split("_"))
        want = j * n[i] + n[i + 1] if j else (n[i - 1] if i else 1)
        first = getattr(model, name)[0]
        assert first.conv1.conv.in_channels == want, name
        assert first.conv1.conv.out_channels == n[i], name


def test_shipped_recipe_builds():
    """configs/acdc/unet++_3d.yaml: BasicBlock, base 32, the anisotropic
    (1, 2, 2) pooling of its first two levels and (1, 3, 3) kernels."""
    pytest.importorskip("yaml")
    from cbim_tpu_torch.config import load_config
    cfg = load_config("acdc", "unet++", "3d")
    model = get_model(cfg, device="cpu")
    assert [p.kernel_size for p in model.pool] == \
        [tuple(s) for s in cfg.down_scale]
    assert isinstance(model.conv0_4[0], convs.BasicBlock)
    assert model.conv0_0[0].conv1.conv.kernel_size == (1, 3, 3)
    assert model.conv4_0[1].conv2.conv.out_channels == 10 * cfg.base_chan
    assert model.output.out_channels == cfg.classes
