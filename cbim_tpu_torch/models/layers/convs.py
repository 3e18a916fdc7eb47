"""Convolutional building blocks (counterpart of
``cbim_tpu/models/layers/convs.py``), as ``nn.Module``s over NCDHW tensors.

Parameter names follow the reference's torch modules (``conv``, ``norm``,
``conv1``/``conv2``/``shortcut``, ``depthwise``/``pointwise``,
``expand_proj``, ``se.excitation``), so a state_dict maps onto the Flax tree
through ``cbim_tpu.utils.torch_import`` unchanged.

Kernel dispatch, one rule per kernel family; both train through their
``torch.autograd.Function`` (backward kernels on CUDA):
- every InstanceNorm(+act) goes through ``InstanceNormAct`` (fused kernels
  on CUDA, any C);
- a ``ConvNormAct`` conv that is 3^3 and not grouped, with C_in <= 192
  and C_out <= 128 (the envelope of the TPU dispatch,
  ``_pallas_conv_usable``), goes through ``Conv3dSame``.
The TPU's NDHCW stage layout (``_stage_cw_ok``, ``to_cw``/``from_cw``) has
no counterpart: the one NDHWC kernel computes the same thing.

These blocks carry no dropout or stochastic depth (MedFormer-3D's recipes
train without them), and every block here is stride 1 (what MedFormer-3D
uses).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.activations import Act, get_act
from ...ops.kernels.conv3d import Conv3dSame
from ...ops.kernels.fused_norm import InstanceNormAct

KernelArg = Union[int, Sequence[int]]


def _tuple(v: KernelArg, n: int) -> tuple:
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(t) for t in v)


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """NCDHW (any memory format) -> a contiguous NDHWC view."""
    return x.contiguous(memory_format=torch.channels_last_3d).movedim(1, -1)


def from_channels_last(t: torch.Tensor) -> torch.Tensor:
    """NDHWC -> NCDHW view in channels_last_3d memory."""
    return t.movedim(-1, 1)


def grouped_conv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (groups > 1) in contiguous NCDHW memory, weight included.

    With the input or the weight in channels_last_3d memory, cuDNN runs a
    grouped 3D conv one channel group at a time: 10-20x slower at the
    MBConv and B-MHA depthwise shapes on an H100 than the same conv in
    contiguous memory, even counting the two layout copies.  (The JAX
    package sidesteps XLA's grouped conv the same way, ``_DepthwiseTapConv``.)
    ``get_model`` keeps grouped weights contiguous.  Returns channels_last_3d
    memory like the other layers."""
    y = F.conv3d(x.contiguous(), conv.weight, conv.bias,
                 padding=conv.padding, groups=conv.groups)
    return y.contiguous(memory_format=torch.channels_last_3d)


def norm_act(x: torch.Tensor, kind, eps: float, act=None) -> torch.Tensor:
    """Norm ``kind`` then ``act`` over x (B, C, *spatial)."""
    if kind in (None, False):
        return get_act(act)(x)
    if kind == "in":
        # torch InstanceNorm defaults: affine=False, no running stats,
        # biased variance over the spatial axes
        return from_channels_last(
            InstanceNormAct.apply(to_channels_last(x), eps, act))
    raise NotImplementedError(
        f"norm {kind!r} is not ported yet (see ROADMAP.md)")


class Norm(nn.Module):
    """Config-selected normalization (parameter-free InstanceNorm here)."""

    def __init__(self, kind="in", eps: float = 1e-4):
        super().__init__()
        self.kind = kind
        self.eps = eps

    def forward(self, x, act=None):
        return norm_act(x, self.kind, self.eps, act)


class ConvNormAct(nn.Module):
    """conv + norm + act, pre- or post-activated (conv_layers.py:16-53);
    stride 1, padding k // 2."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: KernelArg = 3,
                 groups: int = 1, norm="bn", act="relu", preact: bool = False):
        super().__init__()
        k = _tuple(kernel_size, 3)
        self.conv = nn.Conv3d(in_ch, out_ch, k, padding=tuple(ki // 2 for ki in k),
                              groups=groups, bias=False)
        # the reference's dim3 ConvNormAct passes eps=1e-4 (convs.py:415-417)
        self.norm = Norm(norm, eps=1e-4)
        self.act = act
        self.preact = preact
        self.use_kernel = (k == (3, 3, 3) and groups == 1 and in_ch <= 192
                           and out_ch <= 128)

    def _conv(self, x):
        if self.conv.groups > 1:
            return grouped_conv(self.conv, x)
        if self.use_kernel:
            return from_channels_last(
                Conv3dSame.apply(to_channels_last(x), self.conv.weight))
        return self.conv(x)

    def forward(self, x):
        if self.preact:
            return self._conv(self.norm(x, self.act))
        return self.norm(self._conv(x), self.act)


class SingleConv(nn.Module):
    """conv_layers.py:56-68 — one post-activated ConvNormAct."""

    def __init__(self, in_ch, out_ch, kernel_size=3, norm="bn", act="relu"):
        super().__init__()
        self.conv = ConvNormAct(in_ch, out_ch, kernel_size, norm=norm, act=act)

    def forward(self, x):
        return self.conv(x)


class BasicBlock(nn.Module):
    """conv_layers.py:71-94 — preact residual block (2 convs + shortcut)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, norm="bn", act="relu"):
        super().__init__()
        kw = dict(norm=norm, act=act, preact=True)
        self.conv1 = ConvNormAct(in_ch, out_ch, kernel_size, **kw)
        self.conv2 = ConvNormAct(out_ch, out_ch, kernel_size, **kw)
        self.shortcut = (ConvNormAct(in_ch, out_ch, kernel_size, **kw)
                         if in_ch != out_ch else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + (x if self.shortcut is None else self.shortcut(x))


class DepthwiseSeparableConv(nn.Module):
    """conv_layers.py:126-157 — depthwise conv + pointwise conv."""

    def __init__(self, in_ch, out_ch, kernel_size=3):
        super().__init__()
        k = _tuple(kernel_size, 3)
        self.depthwise = nn.Conv3d(in_ch, in_ch, k,
                                   padding=tuple(ki // 2 for ki in k),
                                   groups=in_ch, bias=False)
        self.pointwise = nn.Conv3d(in_ch, out_ch, 1, bias=False)

    def forward(self, x):
        return self.pointwise(grouped_conv(self.depthwise, x))


class SEBlock(nn.Module):
    """conv_layers.py:159-174 — squeeze-and-excitation, ratio 4."""

    def __init__(self, in_ch, act="relu"):
        super().__init__()
        self.excitation = nn.Sequential(
            nn.Conv3d(in_ch, in_ch // 4, 1), Act(act),
            nn.Conv3d(in_ch // 4, in_ch, 1))

    def forward(self, x):
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        return x * torch.sigmoid(self.excitation(s))


class MBConv(nn.Module):
    """conv_layers.py:197-238 — inverted residual, depthwise conv + SE."""

    def __init__(self, in_ch, out_ch, expansion=4, kernel_size=3, norm="bn",
                 act="relu"):
        super().__init__()
        expanded = expansion * in_ch
        self.expand_proj = (
            ConvNormAct(in_ch, expanded, 1, norm=norm, act=act, preact=True)
            if expansion != 1 else None)
        self.depthwise = ConvNormAct(expanded, expanded, kernel_size,
                                     groups=expanded, norm=norm, act=act,
                                     preact=True)
        self.se = SEBlock(expanded, act=act)
        self.pointwise = ConvNormAct(expanded, out_ch, 1, norm=norm, act=False,
                                     preact=True)
        self.shortcut = (ConvNormAct(in_ch, out_ch, kernel_size, norm=False,
                                     act=False) if in_ch != out_ch else None)

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        if self.expand_proj is not None:
            x = self.expand_proj(x)
        return self.pointwise(self.se(self.depthwise(x))) + residual


def get_block_cls(name: str):
    """Reference get_block (model/dim3/utils.py:7-13), by config string."""
    blocks = {"SingleConv": SingleConv, "ConvNormAct": SingleConv,
              "BasicBlock": BasicBlock, "MBConv": MBConv}
    if name not in blocks:
        raise NotImplementedError(
            f"block {name!r} is not ported yet (see ROADMAP.md)")
    return blocks[name]
