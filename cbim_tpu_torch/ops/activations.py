"""Activations of the port (counterpart of ``cbim_tpu/ops/activations.py``
and of ``get_act`` in ``cbim_tpu/models/layers/convs.py``).

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


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.01)``, the JAX package's ``lrelu``."""
    return F.leaky_relu(x, 0.01)


#: every activation the JAX package's ``get_act`` names.  ``prelu`` is
#: ReLU there, a placeholder (PReLU has a parameter, so it is a module:
#: VNet's), and so it is here.
ACTS = {"relu": F.relu, "relu6": F.relu6, "gelu": gelu, "silu": F.silu,
        "swish": F.silu, "lrelu": leaky_relu, "sigmoid": torch.sigmoid,
        "prelu": F.relu, "elu": F.elu}


def get_act(name) -> Callable:
    """Activation function by config name (None/False/"none": identity);
    an unknown name raises KeyError, as in JAX."""
    if name in (None, False, "none"):
        return lambda x: x
    return ACTS[name]


class Act(nn.Module):
    """A config-named activation as a module, for ``nn.Sequential`` slots."""

    def __init__(self, name):
        super().__init__()
        self.name = name
        self.fn = get_act(name)

    def forward(self, x):
        return self.fn(x)
