"""Serving artifacts: the inference programs frozen with ``torch.export``
(counterpart of ``cbim_tpu/inference/export.py``).

The prediction CLI drives live modules.  This module freezes an inference
program, weights included, into bytes that a serving host runs without the
model code, the configs or a checkpoint: :func:`load_exported` needs only
torch and ``cbim_tpu_torch.ops.kernels``, which registers the ``cbim``
custom ops the program calls.  Three program shapes, as in the JAX package:

- the window forward (:func:`export_window_forward`): ``(batch, *window,
  in_chan) -> fp32 softmax probabilities (batch, *window, classes)``, head
  0 of a deep-supervision model, exactly the per-window computation of
  ``make_engine``'s ``apply_fn`` (the model's dtype and memory format, bf16
  autocast where the config computes in bf16 on the card) and the engine's
  fp32 softmax.  The host drives the window sweep;
- the whole image (:func:`export_whole_image`): the window forward at one
  volume shape, batch 1;
- the whole sliding-window program (:func:`export_sliding_window`):
  ``InferenceEngine.sliding_window`` traced for one raw volume shape, ``(1,
  *spatial, in_chan) -> (1, *spatial, classes)``: the pad up to the window,
  the window starts, their multiplicities and the count map baked in as
  constants, the window groups unrolled, the fusion of the config's
  ``window_fusion`` (uniform or Gaussian), the crop.

Where the port differs from the JAX package:

- ``device`` takes the place of ``platforms``: a program is traced, and
  runs, on one device.  Traced on the card it calls the ``cbim`` ops, whose
  CUDA implementations launch the hand-written kernels (and count their
  launches) when the loaded program runs; traced on the CPU it calls the
  same ops, whose CPU implementations are the plain versions.  The JAX
  package lowers one program for any platform, its Pallas kernels kept
  only when it exports on a TPU for a TPU.
- Loading needs ``cbim_tpu_torch.ops.kernels`` beside torch, to register
  the ops; JAX's StableHLO needs only jax.
- The model is moved to ``device`` (``nn.Module.to``, in place) and put in
  eval mode before it is traced.

The artifact is ``torch.export.save``'s archive: the graph, the weights and
the constants.  Programs are specialised to their shapes.  The sharded
sweeps are not exported (nor are they in JAX).
"""

from __future__ import annotations

import io

import torch
from torch import nn


class _Program(nn.Module):
    """The traced function ``fn`` with ``model`` as a submodule, so that
    its parameters and buffers go into the artifact as state."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _engine(model, cfg, device, window_batch=None):
    """``model`` on ``device`` in eval mode, and its engine."""
    from .engines import make_engine
    from ..ops._backend import get_device
    device = get_device(str(device))
    model.to(device).eval()
    return device, make_engine(model, cfg, window_batch)


def _save(program: nn.Module, example: torch.Tensor) -> bytes:
    with torch.no_grad():
        ep = torch.export.export(program, (example,), strict=False)
    # the artifact keeps no copy of the traced example (at a window batch
    # of 6 and 128^3, 50 MB of zeros)
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_window_forward(model, cfg, window_size, in_chan: int, *,
                          batch: int = 1, device="cuda") -> bytes:
    """Serialise one window forward (+ softmax) at a fixed window shape:
    (batch, *window_size, in_chan) float32 in, fp32 probabilities
    (batch, *window_size, classes) out."""
    from .engines import _softmax_fp32
    device, engine = _engine(model, cfg, device)

    def fwd(x):
        return _softmax_fp32(engine.apply_fn(x.movedim(-1, 1))).movedim(1, -1)

    example = torch.zeros((batch, *window_size, in_chan), dtype=torch.float32,
                          device=device)
    return _save(_Program(model, fwd), example)


def export_whole_image(model, cfg, volume_shape, in_chan: int, *,
                       device="cuda") -> bytes:
    """Serialise the whole-image engine (2D/3D) at a fixed volume shape."""
    return export_window_forward(model, cfg, volume_shape, in_chan, batch=1,
                                 device=device)


def export_sliding_window(model, cfg, volume_shape, *, window_batch=1,
                          device="cuda") -> bytes:
    """Serialise the whole sliding-window program for one raw volume shape:
    ``InferenceEngine.sliding_window`` of ``make_engine(model, cfg,
    window_batch)`` (the reference's inference3d.py:28-92 semantics: pad up
    to the window, edge-clamped half-window starts run once each and
    weighted by their multiplicity, softmax-sum fusion over the count map,
    crop back), traced on ``device``.  Input (1, *volume_shape, in_chan)
    float32, ``in_chan`` the config's (default 1)."""
    device, engine = _engine(model, cfg, device, window_batch)
    in_chan = cfg.get("in_chan", 1)
    example = torch.zeros((1, *volume_shape, in_chan), dtype=torch.float32,
                          device=device)
    return _save(_Program(model, engine.sliding_window), example)


def load_exported(data: bytes):
    """bytes -> callable, the inverse of the exporters above: the program
    on the device it was traced on, run under ``torch.inference_mode``.
    Imports ``cbim_tpu_torch.ops.kernels`` (the ``cbim`` ops) and no model
    code."""
    from ..ops import kernels  # noqa: F401  (registers the cbim ops)
    program = torch.export.load(io.BytesIO(data)).module()

    def run(x):
        with torch.inference_mode():
            return program(x)

    return run
