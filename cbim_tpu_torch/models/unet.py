"""UNet / ResUNet, 3D and 2D (counterpart of ``cbim_tpu/models/unet.py``).

- 3D, the reference's model/dim3/unet.py (``UNet3D``): channels base *
  (1, 2, 4, 8, 10), per-level anisotropic kernels and pooling scales, a
  decoder that resizes the coarser map trilinearly to the skip's shape and
  concatenates it after the skip (``UpBlock3D``).
- 2D, model/dim2/unet.py (``UNet2D``): channels base * (1, 2, 4, 8, 16),
  fixed 3x3 kernels, pooling by 2, a decoder that upsamples the coarser
  map bilinearly by 2 (align_corners=True), maps it to the level's width
  by a 1x1 conv with bias (``conv_ch``) and concatenates it after the
  skip (``UpBlock2D``).

``block`` picks the conv block by config string: SingleConv (UNet) or
BasicBlock (ResUNet).  Parameter names are the reference's
(``inc.conv1``/``inc.conv2``, ``down{i}.conv.{1,2}`` after the max-pool at
``.0``, ``up{i}.conv_ch`` in 2D, ``up{i}.conv.{0,1}``, ``outc``), as
``cbim_tpu.utils.torch_import.import_unet`` reads them.  ``InConv``'s
first conv is a plain conv, as in JAX (``nn.Conv``), so it stays cuDNN's;
every ``ConvNormAct`` of the blocks takes the port's kernel routes
(``layers.convs``): the 3^3 conv kernel where C_in <= 192 and C_out <=
128, InstanceNorm(+act) on the fused norm kernels, and with
``conv2d_kernel`` the 3x3 conv kernel where C_in <= 192 and C_out <= 192
(the JAX package's opt-in ``CBIM_PLCONV2D=1`` route).  The 2D models take
BatchNorm, as the JAX factory builds them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.interpolate import resize_linear
from .layers.convs import CONV, _conv, _tuple, get_block_cls, spatial_group

#: the channel multipliers of the 3D and the 2D levels
CH_MULT_3D = (1, 2, 4, 8, 10)
CH_MULT_2D = (1, 2, 4, 8, 16)
#: max-pool module of each spatial rank
MAXPOOL = {2: nn.MaxPool2d, 3: nn.MaxPool3d}


def _blocks(block: str, in_ch: int, out_ch: int, n: int, kernel_size,
            norm, act, nd: int, conv2d_kernel: bool = False) -> list:
    """``n`` blocks, the first taking ``in_ch``; ``conv2d_kernel`` reaches
    every ConvNormAct (it routes only 2D 3x3 convs)."""
    blk = get_block_cls(block)
    return [blk(in_ch if i == 0 else out_ch, out_ch, kernel_size, norm=norm,
                act=act, nd=nd, conv2d_kernel=conv2d_kernel)
            for i in range(n)]


class InConv(nn.Module):
    """A plain conv (``conv1``, no bias) and one block (``conv2``)."""

    def __init__(self, in_ch, out_ch, block, kernel_size=3, norm="bn",
                 act="relu", nd: int = 3, conv2d_kernel: bool = False):
        super().__init__()
        k = _tuple(kernel_size, nd)
        self.conv1 = CONV[nd](in_ch, out_ch, k,
                              padding=tuple(ki // 2 for ki in k), bias=False)
        self.conv2, = _blocks(block, out_ch, out_ch, 1, kernel_size, norm,
                              act, nd, conv2d_kernel)

    def forward(self, x):
        return self.conv2(_conv(self.conv1, x))


class DownBlock(nn.Module):
    """Max-pool by ``scale``, then ``num_block`` blocks: ``conv`` =
    Sequential(pool, blocks) (the factory's ``pool=True``)."""

    def __init__(self, in_ch, out_ch, num_block, block, kernel_size=3,
                 scale=2, norm="bn", act="relu", nd: int = 3,
                 conv2d_kernel: bool = False):
        super().__init__()
        s = _tuple(scale, nd)
        self.conv = nn.Sequential(
            MAXPOOL[nd](s, s),
            *_blocks(block, in_ch, out_ch, num_block, kernel_size, norm, act,
                     nd, conv2d_kernel))

    def forward(self, x):
        return self.conv(x)


class UpBlock3D(nn.Module):
    """Resize the coarser map to the skip's shape (linear,
    align_corners=True), concatenate [skip, coarse], then ``num_block``
    blocks (``conv``)."""

    def __init__(self, low_ch, skip_ch, out_ch, num_block, block,
                 kernel_size=3, norm="bn", act="relu", nd: int = 3,
                 conv2d_kernel: bool = False):
        super().__init__()
        self.conv = nn.Sequential(*_blocks(block, low_ch + skip_ch, out_ch,
                                           num_block, kernel_size, norm, act,
                                           nd, conv2d_kernel))
        #: H-sharded training (``layers.convs.spatial_shard``)
        self.spatial_group = None

    def forward(self, x_low, x_skip):
        x_low = resize_linear(x_low, x_skip.shape[2:], spatial_group(self))
        return self.conv(torch.cat([x_skip, x_low], dim=1))


class UpBlock2D(nn.Module):
    """Upsample the coarser map bilinearly by 2 (align_corners=True), map
    it to ``out_ch`` by a 1x1 conv with bias (``conv_ch``), concatenate
    [skip, coarse], then ``num_block`` blocks (``conv``)."""

    def __init__(self, low_ch, skip_ch, out_ch, num_block, block,
                 kernel_size=3, norm="bn", act="relu", nd: int = 2,
                 conv2d_kernel: bool = False):
        super().__init__()
        self.conv_ch = nn.Conv2d(low_ch, out_ch, 1)
        self.conv = nn.Sequential(*_blocks(block, skip_ch + out_ch, out_ch,
                                           num_block, kernel_size, norm, act,
                                           nd, conv2d_kernel))
        #: H-sharded training (``layers.convs.spatial_shard``)
        self.spatial_group = None

    def forward(self, x_low, x_skip):
        x_low = self.conv_ch(resize_linear(
            x_low, [2 * s for s in x_low.shape[2:]], spatial_group(self)))
        return self.conv(torch.cat([x_skip, x_low], dim=1))


class UNet3D(nn.Module):
    """The reference's model/dim3/unet.py (UNet or ResUNet by ``block``):
    ``scale`` the four pooling scales, ``kernel_size`` the five levels'
    kernels.  ``up_block``: the decoder's block class (AttentionUNet gates
    its skips in its own); ``nd`` and ``ch_mult``: the spatial rank and
    the levels' channel multipliers (``UNet2D`` sets both)."""

    up_block = UpBlock3D
    nd = 3
    ch_mult = CH_MULT_3D

    def __init__(self, in_chan: int, num_classes: int, base_ch: int = 32,
                 scale: Sequence = ((2, 2, 2),) * 4,
                 kernel_size: Sequence = ((3, 3, 3),) * 5,
                 block: str = "SingleConv", norm="bn", act="relu",
                 conv2d_kernel: bool = False):
        super().__init__()
        ch = [base_ch * m for m in self.ch_mult]
        ks, sc = list(kernel_size), list(scale)
        kw = dict(block=block, norm=norm, act=act, nd=self.nd,
                  conv2d_kernel=conv2d_kernel)
        self.inc = InConv(in_chan, ch[0], kernel_size=ks[0], **kw)
        for i in range(4):
            self.add_module(f"down{i + 1}", DownBlock(
                ch[i], ch[i + 1], 2, kernel_size=ks[i + 1], scale=sc[i],
                **kw))
        for i in range(4):
            self.add_module(f"up{i + 1}", self.up_block(
                ch[4 - i], ch[3 - i], ch[3 - i], 2,
                kernel_size=ks[3 - i], **kw))
        self.outc = CONV[self.nd](ch[0], num_classes, 1)

    def forward(self, x):
        skips = [self.inc(x)]
        for i in range(4):
            skips.append(getattr(self, f"down{i + 1}")(skips[-1]))
        out = skips.pop()
        for i in range(4):
            out = getattr(self, f"up{i + 1}")(out, skips.pop())
        return self.outc(out)


class UNet2D(UNet3D):
    """The reference's model/dim2/unet.py (UNet or ResUNet by ``block``):
    channels base * (1, 2, 4, 8, 16), 3x3 kernels, pooling by 2, the
    ``UpBlock2D`` decoder; BatchNorm unless ``norm`` says otherwise (the
    JAX factory passes none)."""

    up_block = UpBlock2D
    nd = 2
    ch_mult = CH_MULT_2D

    def __init__(self, in_chan: int, num_classes: int, base_ch: int = 32,
                 block: str = "SingleConv", norm="bn", act="relu",
                 conv2d_kernel: bool = False):
        super().__init__(in_chan, num_classes, base_ch,
                         scale=((2, 2),) * 4, kernel_size=((3, 3),) * 5,
                         block=block, norm=norm, act=act,
                         conv2d_kernel=conv2d_kernel)
