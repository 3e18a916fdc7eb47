"""Checkpoints (counterpart of ``cbim_tpu/training/checkpoint.py``):
{epoch, step, model, ema, optimizer} with the latest/best file names of the
reference (``fold_<k>_latest.ckpt`` / ``fold_<k>_best.ckpt``, train.py:
104-128).

The payload is ``torch.save`` of state_dicts, written to a temporary file
and renamed, so a reader never sees a torn file.

:func:`load_weights` is the one loader of model weights that the
prediction CLI and the trainer's ``init_model`` share.  It reads this
port's ``.ckpt``, the reference trainer's wrapper and bare ``.pth``
state_dicts.  The JAX package's Flax msgpack ``.ckpt`` files share the
extension but do not load here yet (ROADMAP.md, A5).
"""

from __future__ import annotations

import os
import zipfile

import torch
from torch import nn

from .train_state import TrainState

#: the file extensions :func:`load_weights` reads (``torch.save`` payloads)
WEIGHT_SUFFIXES = (".pth", ".pt", ".ckpt")
#: the keys a reference state_dict may carry that the port's models keep as
#: non-persistent buffers (the Swin family's relative-position index, C8)
DROPPED_KEY = "relative_position_index"


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


def read_state_dict(path: str, prefer_ema: bool = False) -> dict:
    """The model state_dict a weights file holds, by its content:

    - this port's ``.ckpt`` ({epoch, step, model, ema, optimizer}): ``ema``
      when ``prefer_ema`` and it is not None, else ``model``;
    - the reference trainer's wrapper ({model_state_dict,
      ema_model_state_dict, ...}): the EMA weights when present, as
      ``cbim_tpu.utils.torch_import.load_torch_state_dict`` takes them;
    - a bare state_dict: as it is.

    An EMA state_dict carries the trained BatchNorm running statistics (the
    EMA copies buffers).  ``torch.save`` writes a zip archive; a ``.ckpt``
    that is not one is the JAX package's Flax msgpack and raises."""
    if not str(path).endswith(WEIGHT_SUFFIXES):
        raise NotImplementedError(
            f"{path}: the port loads {', '.join(WEIGHT_SUFFIXES)} weights; "
            f"the .npz and swin backbone loaders come with their models "
            f"(see ROADMAP.md)")
    if str(path).endswith(".ckpt") and not zipfile.is_zipfile(path):
        raise NotImplementedError(
            f"{path}: a Flax msgpack .ckpt of the JAX package; loading it "
            f"into the port is ROADMAP.md A5 (checkpoint interop)")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and isinstance(payload.get("model"), dict):
        ema = payload.get("ema")
        return ema if prefer_ema and ema is not None else payload["model"]
    if isinstance(payload, dict) and "model_state_dict" in payload:
        return (payload.get("ema_model_state_dict")
                or payload["model_state_dict"])
    return payload


def load_weights(path: str, model: nn.Module, prefer_ema: bool = False
                 ) -> None:
    """Load the state_dict of ``path`` (:func:`read_state_dict`) into
    ``model``, strictly but for the ``relative_position_index`` buffers of
    a reference Swin checkpoint, which the port rebuilds: any other unknown
    or missing key raises."""
    sd = read_state_dict(path, prefer_ema)
    model.load_state_dict({k: v for k, v in sd.items()
                           if k.rsplit(".", 1)[-1] != DROPPED_KEY})
