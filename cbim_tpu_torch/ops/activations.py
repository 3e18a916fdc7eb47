"""Activations of the port (counterpart of ``cbim_tpu/ops/activations.py``).

GELU is the exact erf form, like ``torch.nn.GELU`` in the reference and
``jax.nn.gelu(approximate=False)`` in ``cbim_tpu``.  The TPU package's bf16
polynomial erf (``fast_gelu``, opt-in there) is a VPU workaround with no
counterpart here.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_grad(n: torch.Tensor) -> torch.Tensor:
    """d gelu(n) / dn = Phi(n) + n * phi(n), exact erf (the plain backward
    of the fused norm; ``_act_grad_fn`` of the JAX package)."""
    return (0.5 * (1.0 + torch.erf(n * 0.7071067811865476))
            + n * 0.3989422804014327 * torch.exp(-0.5 * n * n))


def get_act(name) -> Callable:
    """Activation function by config name (None/False: identity)."""
    if name in (None, False, "none"):
        return lambda x: x
    if name == "relu":
        return F.relu
    if name == "gelu":
        return gelu
    raise NotImplementedError(
        f"activation {name!r} is not ported yet (see ROADMAP.md)")


class Act(nn.Module):
    """A config-named activation as a module, for ``nn.Sequential`` slots."""

    def __init__(self, name):
        super().__init__()
        self.name = name
        self.fn = get_act(name)

    def forward(self, x):
        return self.fn(x)
