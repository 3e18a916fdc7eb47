"""The weights a training run starts from (``--pretrain`` with
``init_model``; counterpart of the ``init_model`` branch of
``cbim_tpu/training/trainer.py`` and of its loaders in
``cbim_tpu/utils/torch_import.py``).

A file is routed by its content, for the model it initialises:

- SwinUNETR and the self-supervised swin-vit backbone (the reference's
  ``model_swinvit.pt``: ``{"state_dict": {"module.*": ...}}``, model/
  utils.py:107-115): only the backbone is written
  (:func:`swin_unetr_ssl_state_dict`, ``import_swin_unetr_ssl``'s map).
  The file is told by a signature key, ``module.patch_embed.proj.weight``
  present and no ``module.swinViT.`` key: the JAX trainer routes any
  ``module.`` prefix there, which fails a DataParallel-saved full
  SwinUNETR (``module.swinViT.*``); here that file loads strictly through
  ``checkpoint.load_weights``, which drops the prefix.
- SwinUnet and the official swin-tiny ImageNet checkpoint (``{"model":
  ...}`` with no ``epoch`` or ``optimizer``, no ``swin_unet.`` prefix, and
  ``patch_embed.proj.weight``; model/utils.py:64): the encoder's
  ``layers.{i}`` mirrored into ``layers_up.{3 - i}``, then loaded
  non-strictly, missing and shape-mismatched keys dropped
  (:func:`swin_tiny_state_dict`, ``import_swinunet_pth``'s surgery).  This
  port's ``.ckpt`` has a ``model`` key too, with ``epoch`` and
  ``optimizer`` beside it, and loads as one.
- TransUNet and the official R50+ViT-B_16 ``.npz`` (model/utils.py:52,
  the reference's ``load_from``; the JAX trainer's ``.npz`` branch,
  ``cbim_tpu/training/trainer.py:121-124``): the stem and the ViT, the
  position embedding fitted to the model's token grid, loaded
  non-strictly: the decoder and the head keep their values
  (:func:`~cbim_tpu_torch.utils.jax_import.transunet_npz_state_dict`).  A
  ``.npz`` for any other model raises, as ``read_payload`` does.
- Anything else: ``checkpoint.load_weights``, the prediction CLI's loader
  (a port ``.ckpt``, a reference wrapper or a JAX package's Flax ``.ckpt``
  gives its EMA weights; a ``.pth`` state_dict itself, UNETR's MONAI-layout
  ``init_model`` among them, strictly).
"""

from __future__ import annotations

import numpy as np
from torch import nn

from ..models.swin_unetr import DEPTHS as SWIN_DEPTHS
from ..utils.jax_import import transunet_npz_state_dict
from .checkpoint import load_weights, read_payload

#: the key that marks the self-supervised swin-vit backbone file
SSL_SIGNATURE = "module.patch_embed.proj.weight"
#: a Swin block's parameters in the SSL file -> in SwinUNETR (its MLP is
#: fc1/fc2 there, MONAI's linear1/linear2 here)
SSL_BLOCK_KEYS = {
    **{f"{m}.{p}": f"{m}.{p}" for m in ("norm1", "norm2", "attn.qkv",
                                        "attn.proj") for p in ("weight",
                                                               "bias")},
    "attn.relative_position_bias_table": "attn.relative_position_bias_table",
    **{f"mlp.fc{i}.{p}": f"mlp.linear{i}.{p}" for i in (1, 2)
       for p in ("weight", "bias")}}
SSL_DOWNSAMPLE_KEYS = ("norm.weight", "norm.bias", "reduction.weight")


def is_swinvit_ssl(sd: dict) -> bool:
    """The self-supervised backbone's layout (C4's signature)."""
    return SSL_SIGNATURE in sd and not any(
        str(k).startswith("module.swinViT.") for k in sd)


def swin_unetr_ssl_state_dict(sd: dict, depths=SWIN_DEPTHS) -> dict:
    """The SSL backbone file's state_dict -> the SwinUNETR keys it sets:
    ``swinViT.patch_embed.proj``, each stage's blocks and downsample.  A
    backbone key the file lacks raises KeyError."""
    out = {f"swinViT.patch_embed.proj.{p}":
           sd[f"module.patch_embed.proj.{p}"] for p in ("weight", "bias")}
    for s, depth in enumerate(depths):
        src, dst = f"module.layers{s + 1}.0", f"swinViT.layers{s + 1}.0"
        for b in range(depth):
            for k_src, k_dst in SSL_BLOCK_KEYS.items():
                out[f"{dst}.blocks.{b}.{k_dst}"] = \
                    sd[f"{src}.blocks.{b}.{k_src}"]
        for k in SSL_DOWNSAMPLE_KEYS:
            out[f"{dst}.downsample.{k}"] = sd[f"{src}.downsample.{k}"]
    return out


def is_swin_tiny(payload) -> bool:
    """The official swin-tiny checkpoint's layout: ``{"model": ...}`` with
    no ``epoch`` or ``optimizer`` (a port ``.ckpt`` has both), no
    ``swin_unet.`` prefix, and the patch embedding."""
    if not (isinstance(payload, dict) and isinstance(payload.get("model"),
                                                     dict)):
        return False
    weights = payload["model"]
    return ("epoch" not in payload and "optimizer" not in payload
            and "patch_embed.proj.weight" in weights
            and not any(str(k).startswith("swin_unet.") for k in weights))


def swin_tiny_state_dict(weights: dict, model_sd: dict) -> dict:
    """The reference's load_from surgery (swin_unet.py:1619-1669) on the
    official file's ``model`` dict: every ``layers.{i}.*`` also as
    ``layers_up.{3 - i}.*``, all under ``swin_unet.``, and only the keys
    the model has at the model's shapes kept."""
    full = dict(weights)
    for k, v in weights.items():
        if k.startswith("layers."):
            full[f"layers_up.{3 - int(k[7])}{k[8:]}"] = v
    return {f"swin_unet.{k}": v for k, v in full.items()
            if f"swin_unet.{k}" in model_sd
            and tuple(v.shape) == tuple(model_sd[f"swin_unet.{k}"].shape)}


def _load_part(model: nn.Module, sd: dict) -> None:
    """Load ``sd``, a part of ``model``'s keys; the rest keep their
    values."""
    _, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected:
        raise RuntimeError(f"keys the model does not have: {unexpected}")


def load_init_model(path: str, model: nn.Module, cfg) -> None:
    """Initialise ``model`` (``cfg``'s model) from ``path``, by the file's
    content (the module docstring's routes)."""
    name = cfg.model
    if name == "transunet" and str(path).endswith(".npz"):
        with np.load(path) as npz:
            _load_part(model, transunet_npz_state_dict(
                npz, model.state_dict()[
                    "transformer.embeddings.position_embeddings"].shape))
        return
    payload = read_payload(path)
    inner = (payload.get("state_dict", payload) if isinstance(payload, dict)
             else payload)
    if name == "swin_unetr" and isinstance(inner, dict) and \
            is_swinvit_ssl(inner):
        _load_part(model, swin_unetr_ssl_state_dict(inner))
    elif name == "swinunet" and is_swin_tiny(payload):
        _load_part(model, swin_tiny_state_dict(payload["model"],
                                               model.state_dict()))
    else:
        load_weights(path, model, prefer_ema=True, cfg=cfg)
