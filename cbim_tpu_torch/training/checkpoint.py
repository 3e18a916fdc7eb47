"""Checkpoints (counterpart of ``cbim_tpu/training/checkpoint.py``):
{epoch, step, model, ema, optimizer} with the latest/best file names of the
reference (``fold_<k>_latest.ckpt`` / ``fold_<k>_best.ckpt``, train.py:
104-128).

The payload is ``torch.save`` of state_dicts, written to a temporary file
and renamed, so a reader never sees a torn file.  The JAX package's Flax
msgpack ``.ckpt`` files do not load here (ROADMAP.md).
"""

from __future__ import annotations

import os

import torch

from .train_state import TrainState


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
