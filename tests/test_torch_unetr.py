"""UNETR in the PyTorch port vs ``cbim_tpu``'s, on the CPU, with the checks
of ``tests/test_torch_unet3d.py``, at hidden 48 (3 heads of 16, MLP 96,
the 12 blocks the model fixes) and feature size 8 on 16 x 32 x 32 crops
(a 1 x 2 x 2 patch grid): the keys round-trip through ``import_unetr``, the eval
forward (no kernel on its path: plain convs, affine instance norms, the
ViT's matmuls) and a 2-step trajectory match the JAX model.  A served
window of another size than ``training_size`` raises, the ViT's blocks,
heads and qkv split hold against JAX's, the shipped recipes build, and the
BCV recipe's ``--pretrain`` ``.pth`` (the reference layout) loads strictly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models import unetr as jax_unetr
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model, unetr
from cbim_tpu_torch.training.train_state import create_train_state
from cbim_tpu_torch.training.trainer import load_pretrained
from cbim_tpu_torch.utils.jax_import import (_Walk, unetr_state_dict_from_jax,
                                             walk_vit)
from test_torch_swin_unetr import jax_params
from test_torch_unet3d import (FWD_SHAPE, ZOO, _x, check_eval_forward,
                               check_round_trip, check_train)
from test_torch_threads import few_torch_threads  # noqa: F401

#: a UNETR at a sixteenth of the ViT's width
D = dict(ZOO, model="unetr", feature_size=8, hidden_size=48, mlp_dim=96,
         unetr_num_heads=3, training_size=[16, 32, 32])


def _case():
    jm = jax_unetr.UNETR(num_classes=3, img_size=(16, 32, 32),
                         feature_size=8, hidden_size=48, mlp_dim=96,
                         num_heads=3)

    def to_jax(sd, template):
        return torch_import.import_unetr(sd, template)

    return D, jm, to_jax, unetr_state_dict_from_jax


def test_keys_round_trip_through_import_unetr():
    check_round_trip(*_case())


def test_eval_forward_matches_jax(monkeypatch):
    got = check_eval_forward(*_case(), monkeypatch)
    assert got == dict(conv3d=0, inorm=0, routed_conv=0, routed_norm=0)


def test_two_step_trajectory_matches_make_train_step():
    check_train(*_case(), shape=FWD_SHAPE)


def test_vit_matches_jax_tokens_and_taps():
    """The ViT alone: the final (post-norm) tokens and every block's output,
    the patch flattening (pz, py, px, C) and the qkv split (q, k, v thirds,
    head-major) included."""
    x = _x((2, 16, 32, 32, 1), 3)
    jv = jax_unetr.ViT(hidden_size=48, mlp_dim=96, num_layers=12,
                       num_heads=3)
    params = jax_params(jv, x.shape, seed=4)
    final, hidden = jv.apply({"params": params}, jnp.asarray(x))
    walk = _Walk({"ViT_0": params})
    walk_vit(walk)
    sd = {k[len("vit."):]: v for k, v in walk.state_dict().items()}
    vit = unetr.ViT(1, (16, 32, 32), 48, 96, 3)
    vit.load_state_dict(sd)
    with torch.inference_mode():
        t_final, t_hidden = vit(torch.from_numpy(x).movedim(-1, 1))
    np.testing.assert_allclose(t_final.numpy(), np.asarray(final), rtol=0,
                               atol=2e-5)
    for i in unetr.VIT_TAPS:
        np.testing.assert_allclose(t_hidden[i].numpy(),
                                   np.asarray(hidden[i]), rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape", [(1, 1, 32, 32, 32), (1, 1, 16, 32, 16),
                                   (1, 1, 16, 32, 40)])
def test_another_input_size_raises(shape):
    """The position embedding is sized by ``training_size``: a window of
    another size (more patches, fewer, or not a multiple of 16) raises
    instead of indexing past it."""
    model = get_model(config_from_dict(D), device="cpu")
    with pytest.raises(ValueError, match="training_size"):
        with torch.inference_mode():
            model(torch.zeros(shape))


UNETR_RECIPES = ["acdc", "bcv", "kits", "lits"]


@pytest.mark.parametrize("dataset", UNETR_RECIPES)
def test_shipped_recipes_build(dataset):
    """Each shipped UNETR yaml builds at the JAX factory's widths (feature
    size 16, hidden 768, MLP 3072, 12 heads), its position embedding sized
    by training_size (BCV's 96^3: 216 patches; ACDC's 16 x 192 x 192:
    1 x 12 x 12)."""
    pytest.importorskip("yaml")
    from cbim_tpu_torch.config import load_config
    cfg = load_config(dataset, "unetr", "3d")
    model = get_model(cfg, device="cpu")
    pe = model.vit.patch_embedding
    assert pe.grid == tuple(s // 16 for s in cfg.training_size)
    assert pe.position_embeddings.shape == (1, int(np.prod(pe.grid)), 768)
    assert len(model.vit.blocks) == 12
    assert model.vit.blocks[0].attn.heads == 12
    assert model.vit.blocks[0].mlp.linear1.out_features == 3072
    assert model.encoder1.layer.conv1.out_channels == 16
    assert model.out.conv.out_channels == cfg.classes


def test_bcv_pretrain_pth_loads_strictly(tmp_path):
    """``--pretrain`` with the BCV recipe's ``init_model``: a reference-
    layout UNETR ``.pth`` (MONAI's {"state_dict": ...} wrapper) sets the
    model and its EMA copy through ``load_weights``, strictly: a stray key
    raises."""
    cfg = config_from_dict(dict(D, pretrain=True, ema=True))
    want = get_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(9)).state_dict()
    path = tmp_path / "UNETR_model_best_acc.pth"
    torch.save({"epoch": 5, "state_dict": want}, path)
    cfg.init_model = str(path)
    state = create_train_state(get_model(cfg, device="cpu", train=True), cfg)
    load_pretrained(cfg, state)
    for sd in (state.model.state_dict(), state.ema.state_dict()):
        for k, v in want.items():
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)
    torch.save({"state_dict": dict(want, **{"vit.extra.weight":
                                            torch.zeros(1)})}, path)
    with pytest.raises(RuntimeError, match="vit.extra"):
        load_pretrained(cfg, state)
