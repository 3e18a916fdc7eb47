"""The UNETR decoder blocks that SwinUNETR uses (counterpart of the blocks of
``cbim_tpu/models/unetr.py``), with MONAI's dynunet parameter names.

- ``InstanceNormAffine``: instance norm with a learned scale and shift
  (``weight``, ``bias``), eps 1e-5, statistics in fp32;
- ``UnetResBlock``: conv-norm-LeakyReLU(0.01) twice with a residual, a 1^3
  conv + norm on the residual where the width changes (``conv1``/``norm1``,
  ``conv2``/``norm2``, ``conv3``/``norm3``);
- ``UnetrBasicBlock`` (``layer``), ``UnetrUpBlock`` (``transp_conv``, a
  2^3 stride-2 transposed conv, then ``conv_block`` on the concatenation
  with the skip) and ``UnetOutBlock`` (``conv``, 1^3 with bias).

These run on plain PyTorch ops (cuDNN convs, elementwise and reduction
kernels): the JAX package runs them in XLA, with no Pallas kernel.  Modules
take and return NCDHW tensors in ``channels_last_3d`` memory.  ViT and
UNETR itself are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

#: LeakyReLU slope and instance-norm eps of MONAI's dynunet blocks
LRELU_SLOPE = 0.01
NORM_EPS = 1e-5


class InstanceNormAffine(nn.Module):
    """Instance norm over the spatial axes with an affine scale and shift:
    y = (x - mean) / sqrt(var + eps) * weight + bias, biased variance in
    fp32, output in x.dtype; applied as one x * a + c pass, which keeps the
    input's memory format."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=tuple(range(2, x.dim())),
                                   unbiased=False, keepdim=True)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        a = torch.rsqrt(var + NORM_EPS) * self.weight.float().view(shape)
        c = self.bias.float().view(shape) - mean * a
        return torch.addcmul(c, x32, a).to(x.dtype)


class UnetResBlock(nn.Module):
    """MONAI's dynunet ``UnetResBlock`` (kernel 3, stride 1)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv3d(in_ch, out_ch, 3, padding=1, bias=False)
        self.norm1 = InstanceNormAffine(out_ch)
        self.conv2 = nn.Conv3d(out_ch, out_ch, 3, padding=1, bias=False)
        self.norm2 = InstanceNormAffine(out_ch)
        self.conv3 = self.norm3 = None
        if in_ch != out_ch:
            self.conv3 = nn.Conv3d(in_ch, out_ch, 1, bias=False)
            self.norm3 = InstanceNormAffine(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.norm1(self.conv1(x)), LRELU_SLOPE)
        out = self.norm2(self.conv2(out))
        res = x if self.conv3 is None else self.norm3(self.conv3(x))
        return F.leaky_relu(out + res, LRELU_SLOPE)


class UnetrBasicBlock(nn.Module):
    """An encoder block: one ``UnetResBlock`` named ``layer``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.layer = UnetResBlock(in_ch, out_ch)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """Upsample by a 2^3 stride-2 transposed conv (no bias), concatenate the
    skip after it, then a ``UnetResBlock``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.transp_conv = nn.ConvTranspose3d(in_ch, out_ch, 2, stride=2,
                                              bias=False)
        self.conv_block = UnetResBlock(2 * out_ch, out_ch)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class UnetOutBlock(nn.Module):
    """The 1^3 output conv (with bias), named ``conv``."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, num_classes, 1)

    def forward(self, x):
        return self.conv(x)
