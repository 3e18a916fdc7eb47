"""UNet / ResUNet (counterpart of ``cbim_tpu/models/unet.py``), the
reference's model/dim3/unet.py: channels base * (1, 2, 4, 8, 10),
per-level anisotropic kernels and pooling scales, a decoder that resizes
the coarser map trilinearly to the skip's shape and concatenates it after
the skip.  ``block`` picks the conv block by config string: SingleConv
(UNet) or BasicBlock (ResUNet).

Parameter names are the reference's (``inc.conv1``/``inc.conv2``,
``down{i}.conv.{1,2}`` after the max-pool at ``.0``, ``up{i}.conv.{0,1}``,
``outc``), as ``cbim_tpu.utils.torch_import.import_unet`` reads them.
``InConv``'s first conv is a plain conv, as in JAX (``nn.Conv``), so it
stays cuDNN's; every ``ConvNormAct`` of the blocks takes the port's kernel
routes (``layers.convs``): the 3^3 conv kernel where C_in <= 192 and C_out
<= 128, InstanceNorm(+act) on the fused norm kernels.  The 2D model
(``UNet2D``, ``UpBlock2D``: bilinear x2, a 1x1 conv, base * 16 at the
bottom) comes with the 2D zoo.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.interpolate import resize_linear
from .layers.convs import CONV, _tuple, get_block_cls

#: the channel multipliers of the 3D levels
CH_MULT_3D = (1, 2, 4, 8, 10)
#: max-pool module of each spatial rank
MAXPOOL = {2: nn.MaxPool2d, 3: nn.MaxPool3d}


def _blocks(block: str, in_ch: int, out_ch: int, n: int, kernel_size,
            norm, act, nd: int) -> list:
    """``n`` blocks, the first taking ``in_ch``."""
    blk = get_block_cls(block)
    return [blk(in_ch if i == 0 else out_ch, out_ch, kernel_size, norm=norm,
                act=act, nd=nd) for i in range(n)]


class InConv(nn.Module):
    """A plain conv (``conv1``, no bias) and one block (``conv2``)."""

    def __init__(self, in_ch, out_ch, block, kernel_size=3, norm="bn",
                 act="relu", nd: int = 3):
        super().__init__()
        k = _tuple(kernel_size, nd)
        self.conv1 = CONV[nd](in_ch, out_ch, k,
                              padding=tuple(ki // 2 for ki in k), bias=False)
        self.conv2, = _blocks(block, out_ch, out_ch, 1, kernel_size, norm,
                              act, nd)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class DownBlock(nn.Module):
    """Max-pool by ``scale``, then ``num_block`` blocks: ``conv`` =
    Sequential(pool, blocks) (the factory's ``pool=True``)."""

    def __init__(self, in_ch, out_ch, num_block, block, kernel_size=3,
                 scale=2, norm="bn", act="relu", nd: int = 3):
        super().__init__()
        s = _tuple(scale, nd)
        self.conv = nn.Sequential(
            MAXPOOL[nd](s, s),
            *_blocks(block, in_ch, out_ch, num_block, kernel_size, norm, act,
                     nd))

    def forward(self, x):
        return self.conv(x)


class UpBlock3D(nn.Module):
    """Resize the coarser map to the skip's shape (trilinear,
    align_corners=True), concatenate [skip, coarse], then ``num_block``
    blocks (``conv``)."""

    def __init__(self, low_ch, skip_ch, out_ch, num_block, block,
                 kernel_size=3, norm="bn", act="relu"):
        super().__init__()
        self.conv = nn.Sequential(*_blocks(block, low_ch + skip_ch, out_ch,
                                           num_block, kernel_size, norm, act,
                                           3))

    def forward(self, x_low, x_skip):
        x_low = resize_linear(x_low, x_skip.shape[2:])
        return self.conv(torch.cat([x_skip, x_low], dim=1))


class UNet3D(nn.Module):
    """The reference's model/dim3/unet.py (UNet or ResUNet by ``block``):
    ``scale`` the four pooling scales, ``kernel_size`` the five levels'
    kernels.  ``up_block``: the decoder's block class (AttentionUNet-3D
    gates its skips in its own)."""

    up_block = UpBlock3D

    def __init__(self, in_chan: int, num_classes: int, base_ch: int = 32,
                 scale: Sequence = ((2, 2, 2),) * 4,
                 kernel_size: Sequence = ((3, 3, 3),) * 5,
                 block: str = "SingleConv", norm="bn", act="relu"):
        super().__init__()
        ch = [base_ch * m for m in CH_MULT_3D]
        ks, sc = list(kernel_size), list(scale)
        kw = dict(block=block, norm=norm, act=act)
        self.inc = InConv(in_chan, ch[0], kernel_size=ks[0], **kw)
        for i in range(4):
            self.add_module(f"down{i + 1}", DownBlock(
                ch[i], ch[i + 1], 2, kernel_size=ks[i + 1], scale=sc[i],
                **kw))
        for i in range(4):
            self.add_module(f"up{i + 1}", self.up_block(
                ch[4 - i], ch[3 - i], ch[3 - i], 2,
                kernel_size=ks[3 - i], **kw))
        self.outc = nn.Conv3d(ch[0], num_classes, 1)

    def forward(self, x):
        skips = [self.inc(x)]
        for i in range(4):
            skips.append(getattr(self, f"down{i + 1}")(skips[-1]))
        out = skips.pop()
        for i in range(4):
            out = getattr(self, f"up{i + 1}")(out, skips.pop())
        return self.outc(out)
