"""Convolutional building blocks (counterpart of
``cbim_tpu/models/layers/convs.py``), as ``nn.Module``s over NCHW / NCDHW
tensors, one implementation for both ranks (``nd`` = 2 or 3).

Parameter names follow the reference's torch modules (``conv``, ``norm``,
``conv1``/``conv2``/``shortcut``, ``depthwise``/``pointwise``,
``expand_proj``, ``se.excitation``, and ``se_block.excitation`` in the dim2
MBConv), so a state_dict maps onto the Flax tree through
``cbim_tpu.utils.torch_import`` unchanged.

Kernel dispatch, one rule per kernel family; each trains through its
``torch.autograd.Function`` (backward kernels on CUDA):
- every InstanceNorm(+act) goes through ``InstanceNormAct`` (fused kernels
  on CUDA, any C);
- a ``ConvNormAct`` conv that is 3^3 and not grouped, with C_in <= 192
  and C_out <= 128 (the envelope of the TPU dispatch,
  ``_pallas_conv_usable``), goes through ``Conv3dSame``;
- a ``ConvNormAct`` conv that is 3x3 and not grouped, with C_in <= 192 and
  C_out <= 192 (``_pallas_conv2d_usable``'s channel envelope), goes through
  ``Conv2dSame`` at any H, W;
- with ``conv_na``, a preact InstanceNorm ``ConvNormAct`` whose conv takes
  ``Conv3dSame`` and whose act the norm kernels fuse goes through
  ``ConvInormAct3d`` instead, norm and conv as one: the JAX package's
  opt-in ``CBIM_CONV_NA=1`` route (``_PallasConvCWNA``).
BatchNorm stays ``F.batch_norm`` (``torch.native_batch_norm`` when
training), as XLA carried Flax's.  The TPU's NDHCW stage layout has no
counterpart: the one NDHWC kernel computes the same thing.

These blocks carry no dropout or stochastic depth (the MedFormer recipes
train without them), and every block here is stride 1.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.activations import Act, get_act
from ...ops.kernels.conv2d import Conv2dSame
from ...ops.kernels.conv3d import Conv3dSame, ConvInormAct3d
from ...ops.kernels.fused_norm import InstanceNormAct, supported_act

KernelArg = Union[int, Sequence[int]]

#: conv module and channels-last memory format of each spatial rank
CONV = {2: nn.Conv2d, 3: nn.Conv3d}
CHANNELS_LAST = {2: torch.channels_last, 3: torch.channels_last_3d}

#: the batch-statistics momentum of Flax's BatchNorm(momentum=0.9):
#: running = 0.9 * running + 0.1 * batch
BN_MOMENTUM = 0.1


def _tuple(v: KernelArg, n: int) -> tuple:
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(t) for t in v)


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """NC(D)HW (any memory format) -> a contiguous N(D)HWC view."""
    return x.contiguous(memory_format=CHANNELS_LAST[x.dim() - 2]).movedim(1, -1)


def from_channels_last(t: torch.Tensor) -> torch.Tensor:
    """N(D)HWC -> NC(D)HW view in channels-last memory."""
    return t.movedim(-1, 1)


def grouped_conv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """A grouped 3D ``conv`` in contiguous NCDHW memory, weight included.

    With the input or the weight in channels_last_3d memory, cuDNN runs a
    grouped 3D conv one channel group at a time: 10-20x slower at the
    MBConv and B-MHA depthwise shapes on an H100 than the same conv in
    contiguous memory, even counting the two layout copies.  (The JAX
    package sidesteps XLA's grouped conv the same way, ``_DepthwiseTapConv``.)
    ``get_model`` keeps grouped 3D weights contiguous.  Returns
    channels_last_3d memory like the other layers.  Grouped 2D convs stay in
    channels_last: there cuDNN's depthwise path is the faster one at the
    MedFormer-2D shapes (``chip_smoke.py`` phase 3, PERF.md)."""
    y = F.conv3d(x.contiguous(), conv.weight, conv.bias,
                 padding=conv.padding, groups=conv.groups)
    return y.contiguous(memory_format=torch.channels_last_3d)


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(conv, nn.Conv3d) and conv.groups > 1:
        return grouped_conv(conv, x)
    return conv(x)


class Norm(nn.Module):
    """Config-selected normalization over x (B, C, *spatial):

    - ``"in"``: parameter-free InstanceNorm (torch's default affine=False,
      biased variance over the spatial axes), fused with ``act``;
    - ``"bn"``: BatchNorm with affine weight/bias and running statistics
      (the reference's ``nn.BatchNorm*d`` names, so ``load_state_dict``
      takes its state_dicts).  It follows Flax's ``BatchNorm(momentum=0.9)``
      rather than torch's: the running variance takes the *biased* batch
      variance, and the statistics stay fp32 under bf16 autocast;
    - ``None``/``False``: identity."""

    def __init__(self, kind="in", eps: float = 1e-4, channels: int | None = None):
        super().__init__()
        self.kind = kind
        self.eps = eps
        if kind == "bn":
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))
            self.register_buffer("num_batches_tracked",
                                 torch.tensor(0, dtype=torch.long))
        elif kind not in ("in", None, False):
            raise NotImplementedError(
                f"norm {kind!r} is not ported yet (see ROADMAP.md)")

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, BN_MOMENTUM, self.eps)
        with torch.no_grad():
            # the biased variance the batch was normalised with, fp32
            var = invstd.float().pow(-2) - self.eps
            self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                mean.float(), alpha=BN_MOMENTUM)
            self.running_var.mul_(1 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
            self.num_batches_tracked += 1
        return y

    def forward(self, x, act=None):
        if self.kind == "in":
            return from_channels_last(
                InstanceNormAct.apply(to_channels_last(x), self.eps, act))
        if self.kind == "bn":
            x = self._batch_norm(x)
        return get_act(act)(x)


class ConvNormAct(nn.Module):
    """conv + norm + act, pre- or post-activated (conv_layers.py:16-53);
    stride 1, padding k // 2.  The reference's dim3 ConvNormAct passes
    eps=1e-4, its dim2 twin torch's default 1e-5 (``cbim_tpu`` convs.py:
    415-417).

    ``conv_na``: compute a preact InstanceNorm 3^3 conv as the fused
    ``ConvInormAct3d`` where it applies (``fused``); the parameters are the
    same either way (the InstanceNorm is affine-free)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: KernelArg = 3,
                 groups: int = 1, norm="bn", act="relu", preact: bool = False,
                 nd: int = 3, conv_na: bool = False):
        super().__init__()
        k = _tuple(kernel_size, nd)
        self.conv = CONV[nd](in_ch, out_ch, k,
                             padding=tuple(ki // 2 for ki in k),
                             groups=groups, bias=False)
        self.norm = Norm(norm, eps=1e-4 if nd == 3 else 1e-5,
                         channels=in_ch if preact else out_ch)
        self.act = act
        self.preact = preact
        self.kernel = None
        if k == (3,) * nd and groups == 1 and in_ch <= 192:
            if nd == 3 and out_ch <= 128:
                self.kernel = Conv3dSame
            elif nd == 2 and out_ch <= 192:
                self.kernel = Conv2dSame
        self.fused = (conv_na and preact and norm == "in"
                      and self.kernel is Conv3dSame and supported_act(act))

    def _conv(self, x):
        if self.kernel is not None:
            return from_channels_last(
                self.kernel.apply(to_channels_last(x), self.conv.weight))
        return _conv(self.conv, x)

    def forward(self, x):
        if self.fused:
            return from_channels_last(ConvInormAct3d.apply(
                to_channels_last(x), self.conv.weight, self.norm.eps,
                self.act))
        if self.preact:
            return self._conv(self.norm(x, self.act))
        return self.norm(self._conv(x), self.act)


class SingleConv(nn.Module):
    """conv_layers.py:56-68 — one post-activated ConvNormAct (``conv_na``
    passes through; it fuses only preact convs)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, norm="bn", act="relu",
                 nd: int = 3, conv_na: bool = False):
        super().__init__()
        self.conv = ConvNormAct(in_ch, out_ch, kernel_size, norm=norm, act=act,
                                nd=nd, conv_na=conv_na)

    def forward(self, x):
        return self.conv(x)


class BasicBlock(nn.Module):
    """conv_layers.py:71-94 — preact residual block (2 convs + shortcut)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, norm="bn", act="relu",
                 nd: int = 3, conv_na: bool = False):
        super().__init__()
        kw = dict(norm=norm, act=act, preact=True, nd=nd, conv_na=conv_na)
        self.conv1 = ConvNormAct(in_ch, out_ch, kernel_size, **kw)
        self.conv2 = ConvNormAct(out_ch, out_ch, kernel_size, **kw)
        self.shortcut = (ConvNormAct(in_ch, out_ch, kernel_size, **kw)
                         if in_ch != out_ch else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + (x if self.shortcut is None else self.shortcut(x))


class DepthwiseSeparableConv(nn.Module):
    """conv_layers.py:126-157 — depthwise conv + pointwise conv."""

    def __init__(self, in_ch, out_ch, kernel_size=3, nd: int = 3):
        super().__init__()
        k = _tuple(kernel_size, nd)
        self.depthwise = CONV[nd](in_ch, in_ch, k,
                                  padding=tuple(ki // 2 for ki in k),
                                  groups=in_ch, bias=False)
        self.pointwise = CONV[nd](in_ch, out_ch, 1, bias=False)

    def forward(self, x):
        return self.pointwise(_conv(self.depthwise, x))


class SEBlock(nn.Module):
    """conv_layers.py:159-174 — squeeze-and-excitation, ratio 4."""

    def __init__(self, in_ch, act="relu", nd: int = 3):
        super().__init__()
        self.excitation = nn.Sequential(
            CONV[nd](in_ch, in_ch // 4, 1), Act(act),
            CONV[nd](in_ch // 4, in_ch, 1))

    def forward(self, x):
        s = x.mean(dim=tuple(range(2, x.dim())), keepdim=True)
        return x * torch.sigmoid(self.excitation(s))


class MBConv(nn.Module):
    """conv_layers.py:197-238 — inverted residual, depthwise conv + SE.  The
    dim2 reference names its SE module ``se_block``, the dim3 one ``se``.
    ``conv_na`` passes through (none of its convs is a fused one: 1x1,
    grouped, or without a norm)."""

    def __init__(self, in_ch, out_ch, expansion=4, kernel_size=3, norm="bn",
                 act="relu", nd: int = 3, conv_na: bool = False):
        super().__init__()
        expanded = expansion * in_ch
        kw = dict(norm=norm, nd=nd, conv_na=conv_na)
        self.expand_proj = (
            ConvNormAct(in_ch, expanded, 1, act=act, preact=True, **kw)
            if expansion != 1 else None)
        self.depthwise = ConvNormAct(expanded, expanded, kernel_size,
                                     groups=expanded, act=act, preact=True,
                                     **kw)
        self.se_name = "se_block" if nd == 2 else "se"
        self.add_module(self.se_name, SEBlock(expanded, act=act, nd=nd))
        self.pointwise = ConvNormAct(expanded, out_ch, 1, act=False,
                                     preact=True, **kw)
        self.shortcut = (ConvNormAct(in_ch, out_ch, kernel_size, norm=False,
                                     act=False, nd=nd, conv_na=conv_na)
                         if in_ch != out_ch else None)

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        if self.expand_proj is not None:
            x = self.expand_proj(x)
        se = getattr(self, self.se_name)
        return self.pointwise(se(self.depthwise(x))) + residual


def get_block_cls(name: str):
    """Reference get_block (model/dim3/utils.py:7-13), by config string."""
    blocks = {"SingleConv": SingleConv, "ConvNormAct": SingleConv,
              "BasicBlock": BasicBlock, "MBConv": MBConv}
    if name not in blocks:
        raise NotImplementedError(
            f"block {name!r} is not ported yet (see ROADMAP.md)")
    return blocks[name]
