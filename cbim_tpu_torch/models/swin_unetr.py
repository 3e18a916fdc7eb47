"""SwinUNETR (Hatamizadeh et al., arXiv:2201.01266), counterpart of
``cbim_tpu/models/swin_unetr.py``: the reference's vendored MONAI model with
its local changes, depths (2, 2, 2, 0) (the 4th stage only downsamples) and
the v0.9.0 'merging' patch merging.  Parameter names are the reference's
(``swinViT.*``, ``encoder{1,2,3,4,10}.layer.*``, ``decoder{5..1}.*``,
``out.conv``), as ``cbim_tpu.utils.torch_import.import_swin_unetr`` reads
them.

The model takes NCDHW in ``channels_last_3d`` memory.  The backbone's token
stages run on ``x.permute(0, 2, 3, 4, 1)`` of the patch embedding, a view
in that layout; its five taps go back to the decoder as NCDHW views.  In
eval mode the six Swin blocks' window attentions run on the fused
window-attention kernel (one launch each per forward); in training mode on
``swin_layers.window_attention_train`` under autograd (the kernel has no
backward), as the JAX package trains it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .swin_layers import PatchMergingLegacy, SwinBlock
from .unetr import UnetOutBlock, UnetrBasicBlock, UnetrUpBlock


#: the Swin window of every stage (its nominal size: it shrinks to the
#: input), the blocks and the heads of each stage
WINDOW = (7, 7, 7)
DEPTHS = (2, 2, 2, 0)
NUM_HEADS = (3, 6, 12, 24)


class PatchEmbed(nn.Module):
    """Non-overlapping 2^3 patches by a strided conv (``proj``), no norm."""

    def __init__(self, in_chan: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv3d(in_chan, embed_dim, 2, stride=2)

    def forward(self, x):
        return self.proj(x)


class BasicLayer(nn.Module):
    """One stage: ``blocks`` (unshifted, then shifted, alternating) and the
    ``downsample`` patch merging."""

    def __init__(self, dim: int, depth: int, num_heads: int):
        super().__init__()
        shift = tuple(w // 2 for w in WINDOW)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, WINDOW,
                      (0, 0, 0) if b % 2 == 0 else shift)
            for b in range(depth))
        self.downsample = PatchMergingLegacy(dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


def proj_out(t: torch.Tensor) -> torch.Tensor:
    """Parameter-free layer norm over C of (B, *spatial, C), in fp32."""
    return F.layer_norm(t.float(), t.shape[-1:], eps=1e-5).to(t.dtype)


class SwinTransformer3D(nn.Module):
    """The backbone (``swinViT``): patch embedding, then four stages; returns
    the five layer-normed taps as NCDHW views."""

    def __init__(self, in_chan: int, embed_dim: int):
        super().__init__()
        self.patch_embed = PatchEmbed(in_chan, embed_dim)
        for i, depth in enumerate(DEPTHS):
            # each stage in a one-element list: the reference's names are
            # layers{i + 1}.0.*
            self.add_module(f"layers{i + 1}", nn.ModuleList([BasicLayer(
                embed_dim * 2 ** i, depth, NUM_HEADS[i])]))

    def forward(self, x: torch.Tensor) -> list:
        x = self.patch_embed(x).permute(0, 2, 3, 4, 1)
        outs = [proj_out(x)]
        for i in range(len(DEPTHS)):
            x = getattr(self, f"layers{i + 1}")[0](x)
            outs.append(proj_out(x))
        return [t.permute(0, 4, 1, 2, 3) for t in outs]


class SwinUNETR(nn.Module):
    """The reference's SwinUNETR (``feature_size`` = the config's
    base_chan): logits (B, classes, D, H, W) in fp32."""

    def __init__(self, in_chan: int, num_classes: int,
                 img_size: Sequence[int] = (96, 96, 96),
                 feature_size: int = 24):
        super().__init__()
        f = feature_size
        self.img_size = tuple(img_size)   # the window it serves; unused
        self.swinViT = SwinTransformer3D(in_chan, f)
        self.encoder1 = UnetrBasicBlock(in_chan, f)
        self.encoder2 = UnetrBasicBlock(f, f)
        self.encoder3 = UnetrBasicBlock(2 * f, 2 * f)
        self.encoder4 = UnetrBasicBlock(4 * f, 4 * f)
        self.encoder10 = UnetrBasicBlock(16 * f, 16 * f)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f)
        self.decoder2 = UnetrUpBlock(2 * f, f)
        self.decoder1 = UnetrUpBlock(f, f)
        self.out = UnetOutBlock(f, num_classes)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        hs = self.swinViT(x_in)
        enc1 = self.encoder2(hs[0])
        enc2 = self.encoder3(hs[1])
        enc3 = self.encoder4(hs[2])
        dec3 = self.decoder5(self.encoder10(hs[4]), hs[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        # encoder1 runs at full resolution: computed just before decoder1,
        # its output is not held through the rest of the decoder
        out = self.decoder1(dec0, self.encoder1(x_in))
        return self.out(out).float()
