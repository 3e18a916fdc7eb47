"""Attention UNet, 3D and 2D (counterpart of
``cbim_tpu/models/attention_unet.py``), the reference's
model/dim{3,2}/attention_unet.py: the UNet encoder, and additive attention
gates on the skips of the decoder.

Parameter names are the reference's (``up{i}.attn.W_g.0``,
``attn.W_x.0``, ``attn.psi.0``, ``up{i}.conv.{0,1}``), as
``cbim_tpu.utils.torch_import.import_attention_unet`` reads them.  The
reference's unused ``conv_ch`` 1x1 conv is left out, as in JAX, in 2D
too: the 2D decoder resizes the coarser map to the skip's shape like the
3D one.  The gate's three InstanceNorms take eps 1e-5 (torch's default;
the blocks' 3D ConvNormAct 1e-4) and run on the fused norm kernels, C = 1
included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interpolate import resize_linear
from .layers.convs import CONV, Norm
from .unet import UNet2D, UNet3D, _blocks

#: the eps of the gate's InstanceNorms (``Norm("in", eps=1e-5)`` in JAX)
GATE_EPS = 1e-5


def _conv_in(in_ch, out_ch, nd):
    """A 1^nd conv without bias, then InstanceNorm (eps 1e-5)."""
    return nn.Sequential(CONV[nd](in_ch, out_ch, 1, bias=False),
                         Norm("in", eps=GATE_EPS))


class AttentionGate(nn.Module):
    """x * sigmoid(IN(psi(relu(IN(W_g g) + IN(W_x x)))))."""

    def __init__(self, g_ch, x_ch, int_ch, nd: int = 3):
        super().__init__()
        self.W_g = _conv_in(g_ch, int_ch, nd)
        self.W_x = _conv_in(x_ch, int_ch, nd)
        self.psi = _conv_in(int_ch, 1, nd)

    def forward(self, g, x):
        psi = self.psi(F.relu(self.W_g(g) + self.W_x(x)))
        return x * torch.sigmoid(psi)


class AttentionUpBlock(nn.Module):
    """Resize the coarser map to the skip's shape, gate the skip with it
    (``attn``, out_ch // 2 gate channels), concatenate [gated skip,
    coarse], then ``num_block`` blocks (``conv``)."""

    def __init__(self, low_ch, skip_ch, out_ch, num_block, block,
                 kernel_size=3, norm="bn", act="relu", nd: int = 3,
                 conv2d_kernel: bool = False):
        super().__init__()
        self.attn = AttentionGate(low_ch, skip_ch, out_ch // 2, nd)
        self.conv = nn.Sequential(*_blocks(block, low_ch + skip_ch, out_ch,
                                           num_block, kernel_size, norm, act,
                                           nd, conv2d_kernel))

    def forward(self, x_low, x_skip):
        x_low = resize_linear(x_low, x_skip.shape[2:])
        x_skip = self.attn(x_low, x_skip)
        return self.conv(torch.cat([x_skip, x_low], dim=1))


class AttentionUNet3D(UNet3D):
    """The reference's model/dim3/attention_unet.py: ``UNet3D`` (channels
    base * (1, 2, 4, 8, 10); the factory passes no act: ReLU) with gated
    up blocks."""

    up_block = AttentionUpBlock


class AttentionUNet2D(UNet2D):
    """The reference's model/dim2/attention_unet.py: ``UNet2D``'s encoder
    (channels base * (1, 2, 4, 8, 16), BatchNorm: the factory passes no
    norm or block, so SingleConv) with gated up blocks."""

    up_block = AttentionUpBlock
