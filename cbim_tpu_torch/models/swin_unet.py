"""SwinUnet (Cao et al., arXiv:2105.05537), counterpart of
``cbim_tpu/models/swin_unet.py``: the reference's model/dim2/swin_unet.py
(the vendored official SwinTransformerSys), with its parameter names
(``swin_unet.patch_embed.*``, ``swin_unet.layers.{i}.blocks.{b}.*``,
``.downsample.*``, ``swin_unet.norm``, ``layers_up.*``,
``concat_back_dim.*``, ``norm_up``, ``up.*``, ``output``), as
``cbim_tpu.utils.torch_import.import_swinunet`` reads them.

- A one-channel input is tiled to three; a patch-4 conv embedding and
  LayerNorm; four stages of Swin blocks (depths (2, 2, 6, 2), heads (3, 6,
  12, 24), windows of 7, unshifted then shifted), each stage's input kept
  as its skip, with ``PatchMergingLegacy``'s 2D branch between them.
- The decoder: LayerNorm and a linear 2x patch expansion, then three
  stages that concatenate the skip, fuse it back to the stage's width with
  a biased linear (``concat_back_dim``), run the *encoder's* depth of the
  stage (the reference builds ``layers_up`` from the encoder depths, not
  ``depths_decoder``) and expand; ``norm_up``, a 4x expansion and a 1x1
  head; the logits in fp32.

The skips line up again only where each merging halves evenly: an input
whose extent, over 4, does not halve three times fails as the JAX model
does (the prediction CLI serves at the training size, 224).

Every window attention takes the route of ``swin_layers``: the kernel in
eval mode (22 launches a forward at the reference's depths), the autograd
route in training mode.  Stochastic depth (``DropPath``, rates a linspace
up to ``drop_path_rate`` over the encoder, each decoder stage reusing its
encoder stage's) sits on both residuals of each block.

The model takes NCHW in ``channels_last`` memory; its token stages run on
(B, H, W, C) views.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .swin_layers import PatchMergingLegacy, SwinBlock, SwinMlp

#: the reference's architecture (SwinUnet_config defaults)
EMBED_DIM = 96
DEPTHS = (2, 2, 6, 2)
NUM_HEADS = (3, 6, 12, 24)
WINDOW = 7
PATCH = 4
DROP_PATH_RATE = 0.1


class PatchExpand2D(nn.Module):
    """PatchExpand: ``expand`` to twice the width, each token's channels as
    a 2 x 2 block of half-width tokens, ``norm``."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 2, eps=1e-5)

    def forward(self, x):
        B, H, W, C = x.shape
        x = self.expand(x).view(B, H, W, 2, 2, C // 2)
        return self.norm(x.permute(0, 1, 3, 2, 4, 5).reshape(
            B, 2 * H, 2 * W, C // 2))


class FinalPatchExpandX4(nn.Module):
    """FinalPatchExpand_X4: ``expand`` to 16 times the width, each token's
    channels as a 4 x 4 block of tokens of the same width, ``norm``."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 16 * dim, bias=False)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        B, H, W, C = x.shape
        x = self.expand(x).view(B, H, W, 4, 4, C)
        return self.norm(x.permute(0, 1, 3, 2, 4, 5).reshape(
            B, 4 * H, 4 * W, C))


class PatchEmbed2D(nn.Module):
    """Non-overlapping patches by a strided conv (``proj``), then ``norm``;
    NCHW in, (B, H, W, C) out."""

    def __init__(self, in_chan: int, embed_dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chan, embed_dim, patch, stride=patch)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


def _blocks(dim, depth, num_heads, window, dpr) -> nn.ModuleList:
    """A stage's blocks: unshifted, then shifted, alternating; the vendored
    Swin block's names (``mlp.fc1``, ``mlp.fc2``)."""
    shift = (window // 2,) * 2
    return nn.ModuleList(
        SwinBlock(dim, num_heads, (window,) * 2,
                  (0, 0) if b % 2 == 0 else shift, drop_path=dpr[b],
                  mlp=SwinMlp)
        for b in range(depth))


class BasicLayer(nn.Module):
    """An encoder stage: ``blocks`` and the ``downsample`` merging (none
    after the last stage)."""

    def __init__(self, dim, depth, num_heads, window, dpr, downsample):
        super().__init__()
        self.blocks = _blocks(dim, depth, num_heads, window, dpr)
        self.downsample = (PatchMergingLegacy(dim, spatial_dims=2)
                           if downsample else None)


class BasicLayerUp(nn.Module):
    """A decoder stage: ``blocks`` and the ``upsample`` expansion (none
    after the last stage)."""

    def __init__(self, dim, depth, num_heads, window, dpr, upsample):
        super().__init__()
        self.blocks = _blocks(dim, depth, num_heads, window, dpr)
        self.upsample = PatchExpand2D(dim) if upsample else None


class SwinTransformerSys(nn.Module):
    """The encoder-decoder and its head (``swin_unet``): (B, C, H, W) ->
    the logits (B, classes, H, W)."""

    def __init__(self, in_chan, num_classes, patch, embed_dim, depths,
                 num_heads, window, drop_path_rate):
        super().__init__()
        nl = len(depths)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        start = [sum(depths[:i]) for i in range(nl)]
        self.patch_embed = PatchEmbed2D(in_chan, embed_dim, patch)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, depths[i], num_heads[i], window,
                       dpr[start[i]:start[i] + depths[i]], i < nl - 1)
            for i in range(nl))
        self.norm = nn.LayerNorm(embed_dim * 2 ** (nl - 1), eps=1e-5)
        # layers_up.0 is the bottleneck's expansion; stage inx (1..nl-1)
        # decodes encoder stage nl - 1 - inx with its depth and rates
        up = [PatchExpand2D(embed_dim * 2 ** (nl - 1))]
        back = [nn.Identity()]
        for inx in range(1, nl):
            s = nl - 1 - inx
            dim = embed_dim * 2 ** s
            back.append(nn.Linear(2 * dim, dim))
            up.append(BasicLayerUp(dim, depths[s], num_heads[s], window,
                                   dpr[start[s]:start[s] + depths[s]],
                                   inx < nl - 1))
        self.layers_up = nn.ModuleList(up)
        self.concat_back_dim = nn.ModuleList(back)
        self.norm_up = nn.LayerNorm(embed_dim, eps=1e-5)
        self.up = FinalPatchExpandX4(embed_dim)
        self.output = nn.Conv2d(embed_dim, num_classes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.patch_embed(x)
        skips = []
        for layer in self.layers:
            skips.append(h)
            for blk in layer.blocks:
                h = blk(h)
            if layer.downsample is not None:
                h = layer.downsample(h)
        h = self.layers_up[0](self.norm(h))
        nl = len(self.layers)
        for inx in range(1, nl):
            h = self.concat_back_dim[inx](
                torch.cat([h, skips[nl - 1 - inx]], dim=-1))
            layer = self.layers_up[inx]
            for blk in layer.blocks:
                h = blk(h)
            if layer.upsample is not None:
                h = layer.upsample(h)
        h = self.up(self.norm_up(h))
        return self.output(h.permute(0, 3, 1, 2))


class SwinUnet2D(nn.Module):
    """The reference's SwinUnet (``swin_unet``): logits (B, classes, H, W)
    in fp32.  ``img_size`` is the size it is built for (224, as the JAX
    factory sets it); the forward reads its input's."""

    def __init__(self, in_chan: int, num_classes: int, img_size: int = 224,
                 patch_size: int = PATCH, embed_dim: int = EMBED_DIM,
                 depths: Sequence[int] = DEPTHS,
                 num_heads: Sequence[int] = NUM_HEADS,
                 window_size: int = WINDOW,
                 drop_path_rate: float = DROP_PATH_RATE):
        super().__init__()
        self.img_size = img_size
        self.swin_unet = SwinTransformerSys(
            3 if in_chan == 1 else in_chan, num_classes, patch_size,
            embed_dim, tuple(depths), tuple(num_heads), window_size,
            drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == 1:
            # the vendored SwinUnet repeats one channel to three
            x = x.repeat(1, 3, 1, 1).contiguous(
                memory_format=torch.channels_last)
        return self.swin_unet(x).float()
