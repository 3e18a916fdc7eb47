"""Attention UNet (counterpart of ``cbim_tpu/models/attention_unet.py``),
the reference's model/dim3/attention_unet.py: the UNet-3D encoder, and
additive attention gates on the skips of the decoder.

Parameter names are the reference's (``up{i}.attn.W_g.0``,
``attn.W_x.0``, ``attn.psi.0``, ``up{i}.conv.{0,1}``), as
``cbim_tpu.utils.torch_import.import_attention_unet`` reads them.  The
reference's unused ``conv_ch`` 1x1 conv is left out, as in JAX.  The
gate's three InstanceNorms take eps 1e-5 (torch's default; the blocks'
ConvNormAct 1e-4) and run on the fused norm kernels, C = 1 included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interpolate import resize_linear
from .layers.convs import Norm
from .unet import UNet3D, _blocks

#: the eps of the gate's InstanceNorms (``Norm("in", eps=1e-5)`` in JAX)
GATE_EPS = 1e-5


def _conv_in(in_ch, out_ch):
    """A 1^3 conv without bias, then InstanceNorm (eps 1e-5)."""
    return nn.Sequential(nn.Conv3d(in_ch, out_ch, 1, bias=False),
                         Norm("in", eps=GATE_EPS))


class AttentionGate(nn.Module):
    """x * sigmoid(IN(psi(relu(IN(W_g g) + IN(W_x x)))))."""

    def __init__(self, g_ch, x_ch, int_ch):
        super().__init__()
        self.W_g = _conv_in(g_ch, int_ch)
        self.W_x = _conv_in(x_ch, int_ch)
        self.psi = _conv_in(int_ch, 1)

    def forward(self, g, x):
        psi = self.psi(F.relu(self.W_g(g) + self.W_x(x)))
        return x * torch.sigmoid(psi)


class AttentionUpBlock(nn.Module):
    """Resize the coarser map to the skip's shape, gate the skip with it
    (``attn``, out_ch // 2 gate channels), concatenate [gated skip,
    coarse], then ``num_block`` blocks (``conv``)."""

    def __init__(self, low_ch, skip_ch, out_ch, num_block, block,
                 kernel_size=3, norm="bn", act="relu"):
        super().__init__()
        self.attn = AttentionGate(low_ch, skip_ch, out_ch // 2)
        self.conv = nn.Sequential(*_blocks(block, low_ch + skip_ch, out_ch,
                                           num_block, kernel_size, norm, act,
                                           3))

    def forward(self, x_low, x_skip):
        x_low = resize_linear(x_low, x_skip.shape[2:])
        x_skip = self.attn(x_low, x_skip)
        return self.conv(torch.cat([x_skip, x_low], dim=1))


class AttentionUNet3D(UNet3D):
    """The reference's model/dim3/attention_unet.py: ``UNet3D`` (channels
    base * (1, 2, 4, 8, 10); the factory passes no act: ReLU) with gated
    up blocks."""

    up_block = AttentionUpBlock
