"""UNet++, 3D and 2D (counterpart of ``cbim_tpu/models/unetpp.py``), the
reference's model/dim{3,2}/unetpp.py: the nested grid of stages x_{i,j}
with dense skips, max-pool down, linear (align_corners=True) upsampling
by each level's scale, one output head.  Channels base * (1, 2, 4, 8, 10)
in 3D, base * (1, 2, 4, 8, 16) with 3x3 kernels and pooling by 2 in 2D.

Parameter names are the reference's (``conv{i}_{j}.{0,1}``, ``output``),
as ``cbim_tpu.utils.torch_import.import_unetpp`` reads them; the blocks'
ConvNormActs take the port's kernel routes (``layers.convs``).  The first
stage's first conv reads the input itself (1 channel in the recipes), so
on the card it takes the CUDA-core route of its conv kernel (a width that
is not a multiple of 8).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.interpolate import resize_linear
from .layers.convs import CONV, _tuple
from .unet import CH_MULT_2D, CH_MULT_3D, MAXPOOL, _blocks


class UNetPlusPlus3D(nn.Module):
    """x_{i,0} = stage(pool(x_{i-1,0})); x_{i,j} = stage(cat(x_{i,0..j-1},
    up(x_{i+1,j-1}))); the head reads x_{0,4}.  Each stage is two blocks
    (``_Stage`` in JAX), row i's at ``kernel_size[i]``.  ``nd`` and
    ``ch_mult``: the spatial rank and the rows' channel multipliers
    (``UNetPlusPlus2D`` sets both)."""

    nd = 3
    ch_mult = CH_MULT_3D

    def __init__(self, in_chan: int, num_classes: int, base_ch: int = 32,
                 scale: Sequence = ((2, 2, 2),) * 4,
                 kernel_size: Sequence = ((3, 3, 3),) * 5,
                 block: str = "SingleConv", norm="bn",
                 conv2d_kernel: bool = False):
        super().__init__()
        nd = self.nd
        n = [base_ch * m for m in self.ch_mult]
        self.scale = [_tuple(s, nd) for s in scale]
        self.pool = nn.ModuleList(MAXPOOL[nd](s, s) for s in self.scale)
        for j in range(5):
            for i in range(5 - j):
                # row i, column j: the row's j earlier maps and the upsampled
                # map below (column 0: the pooled row above, or the input)
                in_ch = (j * n[i] + n[i + 1] if j else
                         (n[i - 1] if i else in_chan))
                self.add_module(f"conv{i}_{j}", nn.Sequential(*_blocks(
                    block, in_ch, n[i], 2, kernel_size[i], norm, "relu", nd,
                    conv2d_kernel)))
        self.output = CONV[nd](n[0], num_classes, 1)

    def _up(self, t, level):
        return resize_linear(t, [d * s for d, s in zip(t.shape[2:],
                                                       self.scale[level])])

    def forward(self, x):
        rows = [[] for _ in range(5)]
        for d in range(5):
            # JAX's order: row d's first map, then the diagonal above it
            rows[d].append(getattr(self, f"conv{d}_0")(
                self.pool[d - 1](rows[d - 1][0]) if d else x))
            for j in range(1, d + 1):
                i = d - j
                up = self._up(rows[i + 1][j - 1], i)
                rows[i].append(getattr(self, f"conv{i}_{j}")(
                    torch.cat([*rows[i], up], dim=1)))
        return self.output(rows[0][4])


class UNetPlusPlus2D(UNetPlusPlus3D):
    """The reference's model/dim2/unetpp.py: channels base * (1, 2, 4, 8,
    16), 3x3 kernels, pooling by 2; the JAX factory passes no block or
    norm (SingleConv, BatchNorm)."""

    nd = 2
    ch_mult = CH_MULT_2D

    def __init__(self, in_chan: int, num_classes: int, base_ch: int = 32,
                 block: str = "SingleConv", norm="bn",
                 conv2d_kernel: bool = False):
        super().__init__(in_chan, num_classes, base_ch,
                         scale=((2, 2),) * 4, kernel_size=(3,) * 5,
                         block=block, norm=norm,
                         conv2d_kernel=conv2d_kernel)
