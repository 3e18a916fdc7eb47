"""Optimizers (counterpart of ``cbim_tpu/training/optim.py``, reference
training/utils.py:8-14).  The trainer sets the learning rate on the param
groups once per epoch.

- SGD: momentum buffer v = mu*v + g, step -lr*v, no Nesterov.
- Adam: L2 weight decay added to the gradient before the moments, eps 1e-8.
- AdamW: eps 1e-5 (the reference's larger eps for mixed precision) and
  decoupled weight decay on ALL parameters, the update of ``optax.adamw``.
"""

from __future__ import annotations

import torch


def get_optimizer(cfg, params) -> torch.optim.Optimizer:
    name = cfg.optimizer
    lr = float(cfg.base_lr)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                               nesterov=False)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=tuple(cfg.betas),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=tuple(cfg.betas),
                                 eps=1e-5, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)
