"""Train state and the train step (counterpart of
``cbim_tpu/training/train_state.py``).

One step: forward under ``torch.autocast`` (bf16 when cfg asks for amp, on
CUDA), CE + Dice with deep supervision, backward, the optimizer step, and
the per-step EMA update (reference training/utils.py:98-105): the EMA
averages the parameters and copies the buffers (BatchNorm's running
statistics), as the JAX step copies ``batch_stats`` into its EMA state.  The
live model trains in train mode (BatchNorm normalises with batch
statistics and updates its running ones); the EMA copy stays in eval mode,
the mode it is evaluated in.  Parameters,
gradients and optimizer state stay fp32, as in the JAX package; bf16 needs
no GradScaler.  Unlike the JAX step, which returns a new state, this one
updates the model, the optimizer state and the EMA copy in place.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..config import compute_dtype
from ..ops.losses import deep_supervision_loss
from .optim import get_optimizer, set_lr


class TrainState:
    """The live model, its optimizer, the EMA copy (None without EMA), the
    number of steps taken, and the generator of the model's stochastic
    depth (None when it has none)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 ema: nn.Module | None = None, step: int = 0,
                 generator: torch.Generator | None = None):
        self.model = model
        self.optimizer = optimizer
        self.ema = ema
        self.step = step
        self.generator = generator


def create_train_state(model: nn.Module, cfg,
                       seed: int | None = None) -> TrainState:
    """Optimizer over every parameter, and an EMA copy (eval mode) when
    ``cfg.ema``.  Every stochastic module of the model with a nonzero rate
    (a module with a rate ``p`` and a ``generator`` slot: ``DropPath``,
    ``Dropout``, VNet's ``ChannelDropout``) draws its keep masks from one
    ``torch.Generator`` on the model's device, which the state owns, seeded
    from ``seed`` (default: the run's ``split_seed``, the JAX step's
    dropout seed) as the input pipeline seeds its own; the EMA copy
    evaluates in eval mode and draws none."""
    opt = get_optimizer(cfg, model.parameters())
    ema = None
    if cfg.get("ema", False):
        ema = copy.deepcopy(model).requires_grad_(False).eval()
    drops = [m for m in model.modules()
             if hasattr(m, "generator") and getattr(m, "p", 0)]
    generator = None
    if drops:
        if seed is None:
            seed = int(cfg.get("split_seed", 0) or 0)
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        for m in drops:
            m.generator = generator
    return TrainState(model, opt, ema, generator=generator)


def make_train_step(model: nn.Module, opt: torch.optim.Optimizer, cfg):
    """``train_step(state, img, lab, lr) -> loss`` for img (B, *spatial, C)
    float and lab (B, *spatial) int on the model's device.  The returned
    loss is a detached device scalar: reading it synchronises."""
    params = list(model.parameters())
    class_weights = None
    if cfg.get("weight"):
        # on the device once: building it per step would copy (and sync)
        class_weights = torch.tensor(cfg.weight, dtype=torch.float32,
                                     device=params[0].device)
    aux_weight = list(cfg.aux_weight) if cfg.aux_loss else [1.0]
    rlt = float(cfg.rlt)
    ema_alpha = float(cfg.ema_alpha)
    amp = compute_dtype(cfg) == torch.bfloat16

    def train_step(state: TrainState, img, lab, lr) -> torch.Tensor:
        set_lr(opt, lr)
        opt.zero_grad(set_to_none=True)
        x = img.movedim(-1, 1)
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=amp and x.is_cuda):
            out = model(x)
            outs = out if isinstance(out, (list, tuple)) else [out]
            loss = deep_supervision_loss(outs, lab, aux_weight,
                                         class_weights, rlt)
        loss.backward()
        # a parameter that no output reads (DAUNet's three unused heads,
        # MedFormer-2D's last semantic-map reductions) has no gradient, and
        # torch's optimizers skip it; the JAX step gives it a zero gradient,
        # so optax decays it (AdamW) or adds its L2 term (Adam): a zero
        # gradient here takes the same update
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        if state.ema is not None:
            # alpha = min(1 - 1/(step+1), ema_alpha), step before the
            # increment (cbim_tpu train_state.py:107-114)
            alpha = min(1.0 - 1.0 / (state.step + 1), ema_alpha)
            with torch.no_grad():
                ema_params = list(state.ema.parameters())
                torch._foreach_mul_(ema_params, alpha)
                torch._foreach_add_(ema_params, params, alpha=1.0 - alpha)
                # buffers copied (cbim_tpu train_state.py:114)
                for e, b in zip(state.ema.buffers(), model.buffers()):
                    e.copy_(b)
        state.step += 1
        return loss.detach()

    return train_step


def eval_variables(state: TrainState, use_ema: bool) -> nn.Module:
    """The module to evaluate: the EMA copy when enabled (reference
    train.py:101), else the live model."""
    if use_ema and state.ema is not None:
        return state.ema
    return state.model
