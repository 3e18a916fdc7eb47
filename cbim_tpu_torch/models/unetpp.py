"""UNet++ (counterpart of ``cbim_tpu/models/unetpp.py``), the reference's
model/dim3/unetpp.py: the nested grid of stages x_{i,j} with dense skips,
max-pool down, linear (align_corners=True) upsampling by each level's
scale, one output head.  Channels base * (1, 2, 4, 8, 10).

Parameter names are the reference's (``conv{i}_{j}.{0,1}``, ``output``),
as ``cbim_tpu.utils.torch_import.import_unetpp`` reads them; the blocks'
ConvNormActs take the port's kernel routes (``layers.convs``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.interpolate import resize_linear
from .layers.convs import _tuple
from .unet import CH_MULT_3D, _blocks


class UNetPlusPlus3D(nn.Module):
    """x_{i,0} = stage(pool(x_{i-1,0})); x_{i,j} = stage(cat(x_{i,0..j-1},
    up(x_{i+1,j-1}))); the head reads x_{0,4}.  Each stage is two blocks
    (``_Stage`` in JAX), row i's at ``kernel_size[i]``."""

    def __init__(self, in_chan: int, num_classes: int, base_ch: int = 32,
                 scale: Sequence = ((2, 2, 2),) * 4,
                 kernel_size: Sequence = ((3, 3, 3),) * 5,
                 block: str = "SingleConv", norm="bn"):
        super().__init__()
        n = [base_ch * m for m in CH_MULT_3D]
        self.scale = [_tuple(s, 3) for s in scale]
        self.pool = nn.ModuleList(nn.MaxPool3d(s, s) for s in self.scale)
        for j in range(5):
            for i in range(5 - j):
                # row i, column j: the row's j earlier maps and the upsampled
                # map below (column 0: the pooled row above, or the input)
                in_ch = (j * n[i] + n[i + 1] if j else
                         (n[i - 1] if i else in_chan))
                self.add_module(f"conv{i}_{j}", nn.Sequential(*_blocks(
                    block, in_ch, n[i], 2, kernel_size[i], norm, "relu", 3)))
        self.output = nn.Conv3d(n[0], num_classes, 1)

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
