"""The Swin family's ``--pretrain`` files in the PyTorch port
(``training.pretrained``, through the trainer's ``load_pretrained``) vs
``cbim_tpu``'s loaders, on files the tests write, on the CPU.

- SwinUNETR's self-supervised swin-vit backbone (``model_swinvit.pt``'s
  layout): only the backbone changes, as ``import_swin_unetr_ssl`` maps it;
  a backbone key the file lacks raises.
- C4's two layouts: that file, told by its signature key, and a
  DataParallel-saved full SwinUNETR (``module.swinViT.*``), which the JAX
  trainer would send to the backbone loader and which loads strictly here.
- SwinUnet's official swin-tiny file (``{"model": ...}``): the encoder
  mirrored into the decoder, loaded non-strictly, against
  ``import_swinunet_pth``; a port ``.ckpt`` (which has a ``model`` key
  too) still loads as one.

Every comparison is exact: loading copies tensors.
"""

import pytest
import torch

from cbim_tpu.models.swin_unet import SwinUnet2D
from cbim_tpu.models.swin_unetr import SwinUNETR as JaxSwinUNETR
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.training import pretrained
from cbim_tpu_torch.training.checkpoint import save_checkpoint
from cbim_tpu_torch.training.train_state import create_train_state
from cbim_tpu_torch.training.trainer import load_pretrained
from cbim_tpu_torch.utils.jax_import import (swin_unetr_state_dict_from_jax,
                                             swinunet_state_dict_from_jax)
from test_torch_swin_unet import TINY as SWINUNET
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401

#: a narrow SwinUNETR with an EMA (relative_position_index buffers at every
#: block in the reference's files)
SWIN = dict(dataset="synthetic", model="swin_unetr", dimension="3d",
            classes=3, in_chan=1, base_chan=12, training_size=[32, 32, 32],
            ema=True, ema_alpha=0.99, optimizer="adamw", base_lr=6e-4)


def _seeded(cfg, seed, train=False):
    return get_model(config_from_dict(cfg), device="cpu", train=train,
                     generator=torch.Generator().manual_seed(seed))


def _state(cfg, init_model, seed=0):
    """A train state of ``cfg``'s model, seeded, with ``init_model``."""
    c = config_from_dict(dict(cfg, init_model=str(init_model),
                              pretrain=True))
    return c, create_train_state(_seeded(cfg, seed, train=True), c)


def _ssl_file(src) -> dict:
    """``src``'s backbone in the SSL file's layout: ``module.`` names, the
    block MLP as ``mlp.fc1``/``fc2``, every block's
    ``relative_position_index`` buffer, and a head the port never reads."""
    out = {}
    for k, v in src.state_dict().items():
        if k.startswith("swinViT."):
            k = "module." + k[len("swinViT."):]
            out[k.replace("mlp.linear", "mlp.fc")] = v.clone()
    for name, m in src.named_modules():
        if name.startswith("swinViT.") and name.endswith(".attn"):
            out[f"module.{name[len('swinViT.'):]}.relative_position_index"] = \
                m.relative_position_index.clone()
    out["module.norm.weight"] = torch.ones(96)
    return {"state_dict": out}


def _assert_equal(got: dict, want: dict, keys):
    for k in keys:
        assert torch.equal(got[k], torch.as_tensor(want[k])), k


def test_ssl_backbone_sets_only_the_backbone(tmp_path):
    """The SSL file initialises ``swinViT.*`` of the model and its EMA
    copy; every other parameter keeps its draw.  The port's result is the
    JAX package's: ``import_swin_unetr_ssl`` on the same file, from the
    same starting weights, carried back by
    ``swin_unetr_state_dict_from_jax``."""
    src = _seeded(SWIN, 1)
    path = tmp_path / "model_swinvit.pt"
    ckpt = _ssl_file(src)
    torch.save(ckpt, path)
    cfg, state = _state(SWIN, path, seed=2)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert pretrained.is_swinvit_ssl(ckpt["state_dict"])
    load_pretrained(cfg, state)
    backbone = {k for k in before if k.startswith("swinViT.")}
    want = {k: v for k, v in src.state_dict().items() if k in backbone}
    for sd in (state.model.state_dict(), state.ema.state_dict()):
        _assert_equal(sd, want, backbone)
        _assert_equal(sd, before, set(before) - backbone)
    assert any(not torch.equal(before[k], want[k]) for k in backbone)

    jm = JaxSwinUNETR(num_classes=3, img_size=(32,) * 3, feature_size=12)
    params = jax_params(jm, (1, 32, 32, 32, 1), seed=0, train=False)
    start = torch_import.import_swin_unetr(
        {k: v.numpy() for k, v in before.items()}, params)
    jax_sd = swin_unetr_state_dict_from_jax(
        torch_import.import_swin_unetr_ssl(ckpt, start))
    _assert_equal(state.model.state_dict(), jax_sd, jax_sd)


def test_ssl_backbone_missing_a_key_raises(tmp_path):
    ckpt = _ssl_file(_seeded(SWIN, 1))
    del ckpt["state_dict"]["module.layers2.0.blocks.1.mlp.fc2.bias"]
    torch.save(ckpt, tmp_path / "ssl.pt")
    cfg, state = _state(SWIN, tmp_path / "ssl.pt")
    with pytest.raises(KeyError, match="layers2.0.blocks.1.mlp.fc2.bias"):
        load_pretrained(cfg, state)


@pytest.mark.parametrize("wrapped", [False, True])
def test_dataparallel_swin_unetr_loads_strictly(tmp_path, wrapped):
    """C4: a full SwinUNETR saved from ``nn.DataParallel`` (every key
    ``module.swinViT.*``, ``module.encoder1.*``, ...; bare or in MONAI's
    ``{"state_dict": ...}``) is not the backbone file: the prefix goes and
    every parameter loads, strictly (a missing key raises)."""
    src = _seeded(SWIN, 3)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    assert not pretrained.is_swinvit_ssl(sd)
    torch.save({"state_dict": sd, "epoch": 7} if wrapped else sd,
               tmp_path / "dp.pth")
    cfg, state = _state(SWIN, tmp_path / "dp.pth")
    load_pretrained(cfg, state)
    for got in (state.model.state_dict(), state.ema.state_dict()):
        _assert_equal(got, src.state_dict(), src.state_dict())
    del sd["module.out.conv.bias"]
    torch.save(sd, tmp_path / "dp_missing.pth")
    cfg, state = _state(SWIN, tmp_path / "dp_missing.pth")
    with pytest.raises(RuntimeError, match="out.conv.bias"):
        load_pretrained(cfg, state)


def _swin_tiny_file(src) -> dict:
    """``src``'s encoder in the official swin-tiny layout: ``{"model":
    ...}`` without the ``swin_unet.`` prefix, its ImageNet head (1000
    classes), every block's ``relative_position_index`` and ``attn_mask``
    buffers, and one parameter of another shape (a 14 x 14 window's
    table), which the load drops."""
    enc = {k[len("swin_unet."):]: v.clone()
           for k, v in src.state_dict().items()
           if k.startswith(("swin_unet.patch_embed.", "swin_unet.layers.",
                            "swin_unet.norm."))}
    enc["head.weight"] = torch.zeros(1000, 96)
    enc["layers.0.blocks.1.attn_mask"] = torch.zeros(16, 49, 49)
    enc["layers.0.blocks.0.attn.relative_position_index"] = \
        torch.zeros(49, 49, dtype=torch.long)
    enc["layers.1.blocks.0.attn.relative_position_bias_table"] = \
        torch.zeros(27 * 27, 6)
    return {"model": enc}


def test_swin_tiny_file_is_mirrored_as_import_swinunet_pth_does(tmp_path):
    """The official file initialises the encoder and, mirrored, the
    decoder's blocks (``layers.{i}`` -> ``layers_up.{3 - i}``) of the model
    and its EMA copy; missing and shape-mismatched keys keep their draw.
    The port's result is the JAX package's: ``import_swinunet_pth`` on the
    same file, from the same starting weights, carried back by
    ``swinunet_state_dict_from_jax``."""
    src = _seeded(SWINUNET, 1)
    ckpt = _swin_tiny_file(src)
    assert pretrained.is_swin_tiny(ckpt)
    torch.save(ckpt, tmp_path / "swin_tiny_patch4_window7_224.pth")
    cfg, state = _state(SWINUNET, tmp_path / "swin_tiny_patch4_window7_224"
                        ".pth", seed=2)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    load_pretrained(cfg, state)
    got = state.model.state_dict()
    mirrored = "swin_unet.layers_up.3.blocks.1.mlp.fc2.weight"
    assert torch.equal(got[mirrored],
                       src.state_dict()["swin_unet.layers.0.blocks.1.mlp."
                                        "fc2.weight"])
    mismatched = "swin_unet.layers.1.blocks.0.attn.relative_position_bias_" \
        "table"
    assert torch.equal(got[mismatched], before[mismatched])
    for k in ("swin_unet.output.weight", "swin_unet.concat_back_dim.1.bias",
              "swin_unet.layers_up.1.upsample.expand.weight"):
        assert torch.equal(got[k], before[k]), k
    _assert_equal(state.ema.state_dict(), got, got)

    jm = SwinUnet2D(num_classes=4, embed_dim=12, drop_path_rate=0.0)
    params = jax_params(jm, (1, 64, 64, 1), seed=0, train=False)
    start = torch_import.import_swinunet(
        {k: v.numpy() for k, v in before.items()}, params)
    jax_sd = swinunet_state_dict_from_jax(
        torch_import.import_swinunet_pth(ckpt, start))
    assert set(jax_sd) == set(got)
    _assert_equal(got, jax_sd, jax_sd)


@pytest.mark.parametrize("kind", ["ckpt", "reference"])
def test_swinunet_port_ckpt_and_reference_pth_still_load(tmp_path, kind):
    """A port ``.ckpt`` of a SwinUnet (``model`` beside ``epoch`` and
    ``optimizer``) is not the swin-tiny file: it loads as one, its EMA
    weights into the model and its EMA copy.  So does a reference
    ``.pth`` (``swin_unet.*`` keys with its ``relative_position_index``
    and ``attn_mask`` buffers), strictly."""
    src_cfg, src = _state(SWINUNET, "unused", seed=4)
    if kind == "ckpt":
        with torch.no_grad():
            for p in src.ema.parameters():
                p.add_(1.0)
        path = tmp_path / "fold_0_latest.ckpt"
        save_checkpoint(str(path), src, 3)
        assert not pretrained.is_swin_tiny(torch.load(path,
                                                      weights_only=True))
        want = src.ema.state_dict()
    else:
        path = tmp_path / "swinunet_ref.pth"
        want = src.model.state_dict()
        sd = dict(want)
        sd["swin_unet.layers.0.blocks.1.attn_mask"] = torch.zeros(9, 49, 49)
        sd["swin_unet.layers.0.blocks.1.attn.relative_position_index"] = \
            torch.zeros(49, 49, dtype=torch.long)
        torch.save(sd, path)
    cfg, state = _state(SWINUNET, path, seed=5)
    load_pretrained(cfg, state)
    for got in (state.model.state_dict(), state.ema.state_dict()):
        _assert_equal(got, want, want)


def test_ssl_map_covers_every_backbone_parameter():
    """The backbone map sets every ``swinViT.*`` parameter of the port's
    SwinUNETR, and nothing else."""
    model = _seeded(SWIN, 0)
    ssl = pretrained.swin_unetr_ssl_state_dict(
        _ssl_file(model)["state_dict"])
    assert set(ssl) == {k for k in model.state_dict()
                        if k.startswith("swinViT.")}
