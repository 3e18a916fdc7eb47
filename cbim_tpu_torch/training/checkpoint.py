"""Checkpoints (counterpart of ``cbim_tpu/training/checkpoint.py``):
{epoch, step, model, ema, optimizer} with the latest/best file names of the
reference (``fold_<k>_latest.ckpt`` / ``fold_<k>_best.ckpt``, train.py:
104-128).

The payload is ``torch.save`` of state_dicts, written to a temporary file
and renamed, so a reader never sees a torn file.

:func:`load_weights` is the one loader of model weights that the
prediction CLI and the trainer's ``init_model`` share.  It reads this
port's ``.ckpt``, the reference trainer's wrapper, MONAI's
``{"state_dict": ...}`` and bare ``.pth`` state_dicts, with or without
DataParallel's ``module.`` prefix (``training.pretrained`` routes the
backbone files that initialise only part of a model), and the JAX
package's Flax msgpack ``.ckpt`` ({epoch, step, params, ema_params,
batch_stats, ema_batch_stats, opt_state}, ``cbim_tpu/training/
checkpoint.py``), told apart from ``torch.save``'s zip archive by content,
read by ``utils.flax_msgpack`` and mapped onto the config's model by
``utils.jax_import.state_dict_from_jax``: that needs the config.  A Flax
file's BatchNorm statistics load into the running buffers (the JAX CLI
serves with initial ones, ROADMAP C10).  Its ``opt_state`` is not read:
resuming a JAX run's AdamW state is not supported.  Orbax checkpoint
directories (``<path>.orbax``) need jax and are refused.  The blocks and
norms the port took last (Bottleneck, FusedMBConv, MBConv in the UNet
family, ConvNeXtBlock, LayerNorm, MedFormer's linear projections) load
strictly under the names their modules' docstrings give (Bottleneck's are
the reference's ``conv1``/``conv2``/``conv3``/``shortcut``); no reference
``.pth`` of them has been loaded (there is none in the repository).
"""

from __future__ import annotations

import os
import zipfile

import torch
from torch import nn

from ..utils.flax_msgpack import read_flax_msgpack
from ..utils.jax_import import state_dict_from_jax
from .train_state import TrainState

#: the file extensions :func:`load_weights` reads (``torch.save`` payloads;
#: ``.ckpt`` also the JAX package's Flax msgpack)
WEIGHT_SUFFIXES = (".pth", ".pt", ".ckpt")
#: the suffix of the JAX package's Orbax checkpoint directories
ORBAX_SUFFIX = ".orbax"
#: the keys a reference state_dict may carry that the port's models build
#: from the geometry instead: the Swin family's relative-position index, a
#: non-persistent buffer here (C8), and the shifted-window mask that the
#: vendored SwinUnet keeps as a buffer (region ids here)
DROPPED_KEYS = ("relative_position_index", "attn_mask")


def save_checkpoint(path: str, state: TrainState, epoch: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "step": int(state.step),
        "model": state.model.state_dict(),
        "ema": state.ema.state_dict() if state.ema is not None else None,
        "optimizer": state.optimizer.state_dict(),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state: TrainState) -> tuple[TrainState, int]:
    """Restore model, EMA, optimizer and step into ``state`` in place;
    returns (state, the epoch to start from)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    if state.ema is not None:
        state.ema.load_state_dict(payload["ema"] if payload["ema"] is not None
                                  else payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"])


def read_payload(path: str):
    """What a weights file holds: ``torch.save``'s payload, or for a
    ``.ckpt`` that is not a zip archive the JAX package's Flax msgpack tree
    (``is_flax_payload``).  A suffix the port does not load raises, and so
    does an Orbax directory (it needs jax)."""
    path = str(path)
    if path.endswith(ORBAX_SUFFIX) or os.path.isdir(path + ORBAX_SUFFIX):
        raise NotImplementedError(
            f"{path}: an Orbax checkpoint directory of the JAX package; "
            f"reading it needs jax and orbax, which the port does not use. "
            f"Write the checkpoint with the JAX package's msgpack backend")
    if not path.endswith(WEIGHT_SUFFIXES):
        raise NotImplementedError(
            f"{path}: the port loads {', '.join(WEIGHT_SUFFIXES)} weights; "
            f"a .npz loads only as TransUNet's --pretrain backbone (the "
            f"official R50+ViT-B_16 file)")
    if path.endswith(".ckpt") and not zipfile.is_zipfile(path):
        return read_flax_msgpack(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def is_flax_payload(payload) -> bool:
    """The JAX package's checkpoint tree: ``params`` beside ``step`` (no
    ``torch.save`` payload the port reads has either)."""
    return (isinstance(payload, dict) and isinstance(payload.get("params"),
                                                     dict)
            and "step" in payload)


def flax_state_dict(payload, cfg, prefer_ema: bool = False) -> dict:
    """The state_dict of a Flax checkpoint tree for the model ``cfg``
    selects: ``ema_params`` and ``ema_batch_stats`` with ``prefer_ema``
    where the run kept them (an EMA-less run writes ``{}``), else
    ``params`` and ``batch_stats``."""
    if cfg is None:
        raise ValueError(
            "a Flax msgpack checkpoint of the JAX package maps onto a model "
            "only through its config: pass cfg")

    def pick(key):
        ema = payload.get(f"ema_{key}")
        return ema if prefer_ema and ema else payload.get(key) or {}

    return state_dict_from_jax(cfg, {"params": pick("params"),
                                     "batch_stats": pick("batch_stats")})


def state_dict_of(payload, prefer_ema: bool = False, cfg=None) -> dict:
    """The model state_dict a payload holds, by its content:

    - this port's ``.ckpt`` ({epoch, step, model, ema, optimizer}): ``ema``
      when ``prefer_ema`` and it is not None, else ``model``;
    - the reference trainer's wrapper ({model_state_dict,
      ema_model_state_dict, ...}): the EMA weights when present, as
      ``cbim_tpu.utils.torch_import.load_torch_state_dict`` takes them;
    - MONAI's ({state_dict, ...}): ``state_dict``;
    - the JAX package's Flax tree: :func:`flax_state_dict` for ``cfg``;
    - a bare state_dict: as it is.

    A state_dict saved from ``nn.DataParallel`` (every key ``module.*``)
    loses that prefix.  An EMA state_dict carries the trained BatchNorm
    running statistics (the EMA copies buffers)."""
    if is_flax_payload(payload):
        return flax_state_dict(payload, cfg, prefer_ema)
    sd = payload
    if isinstance(payload, dict) and isinstance(payload.get("model"), dict):
        ema = payload.get("ema")
        sd = ema if prefer_ema and ema is not None else payload["model"]
    elif isinstance(payload, dict) and "model_state_dict" in payload:
        sd = (payload.get("ema_model_state_dict")
              or payload["model_state_dict"])
    elif isinstance(payload, dict) and isinstance(payload.get("state_dict"),
                                                  dict):
        sd = payload["state_dict"]
    if sd and all(str(k).startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def read_state_dict(path: str, prefer_ema: bool = False, cfg=None) -> dict:
    """The model state_dict of a weights file (:func:`read_payload`,
    :func:`state_dict_of`; a Flax file needs ``cfg``)."""
    return state_dict_of(read_payload(path), prefer_ema, cfg)


def load_weights(path: str, model: nn.Module, prefer_ema: bool = False,
                 cfg=None) -> None:
    """Load the state_dict of ``path`` (:func:`read_state_dict`) into
    ``model``, strictly but for the buffers a reference Swin checkpoint
    carries and the port rebuilds (``DROPPED_KEYS``): any other unknown or
    missing key raises.  ``cfg``, the model's config, maps a Flax
    checkpoint (and is required for one)."""
    sd = read_state_dict(path, prefer_ema, cfg)
    model.load_state_dict({k: v for k, v in sd.items()
                           if k.rsplit(".", 1)[-1] not in DROPPED_KEYS})
