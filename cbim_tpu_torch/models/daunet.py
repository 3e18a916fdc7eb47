"""Dual-Attention UNet, 2D (counterpart of ``cbim_tpu/models/daunet.py``),
the reference's model/dim2/dual_attention_unet.py: ``UNet2D``'s encoder
and decoder with a DAHead on the bottleneck, position attention (PAM:
pixel-pair affinity) and channel attention (CAM: a Gram matrix over the
channels), each with a learned residual gain ``gamma`` that starts at
zero.  Both attentions' logits and softmax run in fp32.

Parameter names are the reference's, as
``cbim_tpu.utils.torch_import.import_daunet`` reads them:
``DAModule.conv_a.{0,2}`` (BatchNorm, then a 3x3 conv without bias),
``DAModule.sa.{query,key,value}_conv`` and ``sa.gamma``,
``DAModule.conv_a_1.{0,2}`` (BatchNorm, a 1x1 conv), ``conv_c``,
``sc.gamma``, ``conv_c_1``, and the three 1x1 heads ``fuse_out.1``,
``conv_a_out.1`` and ``conv_c_out.1``.  The heads feed no output: the JAX
model builds them and its compiled forward drops them, so they are
parameters here that no forward reads (the train step gives them a zero
gradient, as JAX's does).  These are plain PyTorch ops (cuDNN, cuBLAS), as
XLA carried them; the blocks of the UNet body take the port's kernel
routes (``layers.convs``).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers.convs import Norm
from .unet import UNet2D

#: the BatchNorm eps of the head (``Norm("bn", eps=1e-5)`` in JAX)
HEAD_EPS = 1e-5


def _bn_relu_conv(in_ch: int, out_ch: int, k: int) -> nn.Sequential:
    """BatchNorm (``.0``), ReLU (``.1``), a k x k conv (``.2``, with a bias
    only at k = 1)."""
    return nn.Sequential(Norm("bn", eps=HEAD_EPS, channels=in_ch), nn.ReLU(),
                         nn.Conv2d(in_ch, out_ch, k, padding=k // 2,
                                   bias=k == 1))


def _head(in_ch: int, num_classes: int) -> nn.Sequential:
    """A 1x1 head at ``.1`` (the reference's dropout at ``.0`` does nothing
    to parameters)."""
    return nn.Sequential(nn.Identity(), nn.Conv2d(in_ch, num_classes, 1))


class PAM(nn.Module):
    """Position attention: out = gamma * (V softmax(Q^T K)^T) + x, Q and K
    at C / 8 channels."""

    def __init__(self, ch: int, reduction: int = 8):
        super().__init__()
        self.query_conv = nn.Conv2d(ch, ch // reduction, 1)
        self.key_conv = nn.Conv2d(ch, ch // reduction, 1)
        self.value_conv = nn.Conv2d(ch, ch, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        B, C, H, W = x.shape

        def tokens(t):                      # (B, c, H, W) -> (B, HW, c)
            return t.flatten(2).transpose(1, 2)

        q, k, v = (tokens(c(x)) for c in (self.query_conv, self.key_conv,
                                          self.value_conv))
        attn = torch.matmul(q.float(), k.float().transpose(1, 2))
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = torch.matmul(attn, v)                      # (B, HW, C)
        out = out.transpose(1, 2).reshape(B, C, H, W)
        return self.gamma * out + x


class CAM(nn.Module):
    """Channel attention: energy = X X^T over the channels; out = gamma *
    softmax(max(energy) - energy) X + x."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        B, C, H, W = x.shape
        flat = x.reshape(B, C, H * W)
        energy = torch.matmul(flat.float(), flat.float().transpose(1, 2))
        energy = energy.amax(dim=-1, keepdim=True) - energy
        attn = energy.softmax(dim=-1).to(x.dtype)
        out = torch.matmul(attn, flat).reshape(B, C, H, W)
        return self.gamma * out + x


class DAHead(nn.Module):
    """The reference's DAModule: two branches from ``in_ch`` to ``in_ch //
    4`` and back, PAM in one and CAM in the other; returns their sum."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        inter = in_ch // 4
        self.conv_a = _bn_relu_conv(in_ch, inter, 3)
        self.sa = PAM(inter)
        self.conv_a_1 = _bn_relu_conv(inter, in_ch, 1)
        self.conv_c = _bn_relu_conv(in_ch, inter, 3)
        self.sc = CAM()
        self.conv_c_1 = _bn_relu_conv(inter, in_ch, 1)
        self.fuse_out = _head(in_ch, num_classes)
        self.conv_a_out = _head(in_ch, num_classes)
        self.conv_c_out = _head(in_ch, num_classes)

    def forward(self, x):
        sa = self.conv_a_1(self.sa(self.conv_a(x)))
        sc = self.conv_c_1(self.sc(self.conv_c(x)))
        return sa + sc


class DAUNet2D(UNet2D):
    """The reference's model/dim2/dual_attention_unet.py: ``UNet2D``
    (channels base * (1, 2, 4, 8, 16), BatchNorm, ``block`` from the
    config) with ``DAModule`` on the bottleneck before the decoder."""

    def __init__(self, in_chan: int, num_classes: int, base_ch: int = 32,
                 block: str = "BasicBlock", conv2d_kernel: bool = False):
        super().__init__(in_chan, num_classes, base_ch, block=block,
                         conv2d_kernel=conv2d_kernel)
        self.DAModule = DAHead(16 * base_ch, num_classes)

    def forward(self, x):
        skips = [self.inc(x)]
        for i in range(4):
            skips.append(getattr(self, f"down{i + 1}")(skips[-1]))
        out = self.DAModule(skips.pop())
        for i in range(4):
            out = getattr(self, f"up{i + 1}")(out, skips.pop())
        return self.outc(out)
