"""VT-UNet (Peiris et al., arXiv:2111.13300), counterpart of
``cbim_tpu/models/vtunet.py``: the reference's model/dim3/vtunet.py and
vtunet_utils.py (SwinTransformerSys3D), with its parameter names
(``swin_unet.patch_embed.*``, ``swin_unet.layers.{i}.blocks.{b}.*``,
``.downsample.*``, ``swin_unet.norm``, ``layers_up.*``, ``concat_back_dim.*``,
``norm_up``, ``up.*``, ``output``), as
``cbim_tpu.utils.torch_import.import_vtunet`` reads them.

- A strided-conv patch embedding and LayerNorm, then four encoder stages
  (depths (2, 2, 2, 1), heads (3, 6, 12, 24)) of Swin blocks; the patch
  merging between them halves H and W only.  Each stage keeps the k and v
  of its even (unshifted) and odd (shifted) blocks for the decoder.
- The decoder: a linear 2x H/W patch expansion, then three stages of
  blocks that attend twice, to themselves and, with their own q, to the
  encoder stage's cached k and v (even blocks the unshifted cache, odd
  blocks the shifted one), and fuse the two as 0.5 x + 0.5 x2 +
  MLP(LN(a sin-cos positional encoding)).  The cross path scales q twice,
  a quirk of the reference (vtunet_utils.py:418-419) kept here.
- A final pixel-shuffle expansion by the patch size and a 1x1x1 head; the
  logits in fp32.

Every window attention takes the route of ``swin_layers``: the kernel in
eval mode (both paths; 19 launches a forward at the default depths), the
autograd route in training mode.  Stochastic depth (``DropPath``, rates a
linspace up to ``drop_path_rate``) sits on four residuals of each block.

The model takes NCDHW in ``channels_last_3d`` memory; its token stages run
on (B, D, H, W, C) views.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from .swin_layers import (DropPath, ShiftedWindows, SwinMlp,
                          WindowAttention)

#: the reference's architecture (model/dim3/vtunet.py)
EMBED_DIM = 96
DEPTHS = (2, 2, 2, 1)
NUM_HEADS = (3, 6, 12, 24)
WINDOW = (7, 7, 7)
DROP_PATH_RATE = 0.1


def positional_encoding_3d(spatial, channels: int) -> np.ndarray:
    """The sin-cos 3D positional embedding (vtunet_utils.py:457-530), (1,
    *spatial, channels) float32: sin and cos of each axis' position at
    ceil(channels / 6) * 2 frequencies, D's, H's and W's features in that
    order, cut to ``channels``."""
    ch = int(np.ceil(channels / 6) * 2)
    if ch % 2:
        ch += 1
    inv_freq = 1.0 / (10000 ** (np.arange(0, ch, 2, dtype=np.float32) / ch))
    d, h, w = spatial
    emb = np.zeros((d, h, w, ch * 3), np.float32)

    def axis_emb(n):
        s = np.einsum("i,j->ij", np.arange(n, dtype=np.float32), inv_freq)
        return np.concatenate([np.sin(s), np.cos(s)], axis=-1)

    emb[..., :ch] = axis_emb(d)[:, None, None, :]
    emb[..., ch:2 * ch] = axis_emb(h)[None, :, None, :]
    emb[..., 2 * ch:] = axis_emb(w)[None, None, :, :]
    return emb[None, ..., :channels]


def _heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, hd) -> (B, N, H hd)."""
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


class WindowAttentionVT(WindowAttention):
    """WindowAttention3D (vtunet_utils.py:243-455): ``qkv``, ``proj``,
    ``relative_position_bias_table``, and the decoder's cross path.
    Returns the self path's output, the cross path's (None without a
    cache) and this block's (k, v), the cache a decoder block attends to
    (the reference's cached q is never read)."""

    def forward(self, x: torch.Tensor, region: torch.Tensor | None = None,
                cache: tuple | None = None):
        b, n, c = x.shape
        q, k, v = self.qkv_views(x)
        bias = self.rel_bias(n)
        # the attention scales q k by hd^-1/2 itself
        out = self.proj(_heads(self.attend(q, k, v, bias, region)))
        x2 = None
        if cache is not None:
            # the reference scales the decoder's q twice for the cross path
            qc, (kc, vc) = q * (c // self.num_heads) ** -0.5, cache
            if not self.training:
                # the kernel takes q, k, v of one set of strides: packed
                # into one (b, n, 3, h, hd) tensor, as the qkv views are
                qc, kc, vc = torch.stack(
                    [t.transpose(1, 2) for t in (qc, kc, vc)],
                    dim=2).permute(2, 0, 3, 1, 4)
            x2 = self.proj(_heads(self.attend(qc, kc, vc, bias, region)))
        return out, x2, (k, v)


class SwinBlockVT(ShiftedWindows):
    """SwinTransformerBlock3D (vtunet_utils.py:533-806): ``norm1``,
    ``attn``, ``norm2``, ``mlp``.  ``norm2`` and the MLP serve the self
    path, the cross path and the positional-encoding term alike, and one
    ``DropPath`` sits on the four residuals (a fresh draw each).  Returns
    the block's output and its (k, v) cache."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int],
                 shift_size: Sequence[int], drop_path: float = 0.0):
        super().__init__(window_size, shift_size)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttentionVT(dim, num_heads, self.window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = SwinMlp(dim)
        self.drop_path = DropPath(drop_path)
        self._pe: dict = {}

    def _ffn(self, t):
        return self.mlp(self.norm2(t))

    def _pos_encoding(self, spatial, c, device):
        """positional_encoding_3d of this grid on ``device`` (cached)."""
        key = (spatial, c, device)
        if key not in self._pe:
            self._pe[key] = torch.from_numpy(
                positional_encoding_3d(spatial, c)).to(device)
        return self._pe[key]

    def forward(self, x: torch.Tensor, cache: tuple | None = None):
        wins, region, layout = self.partition(self.norm1(x))
        out, x2, kv = self.attn(wins, region, cache)
        dp = self.drop_path
        shortcut = x
        x = shortcut + dp(self.unpartition(out, layout))
        x = x + dp(self._ffn(x))
        if x2 is not None:
            x2 = shortcut + dp(self.unpartition(x2, layout))
            x2 = x2 + dp(self._ffn(x2))
            pe = self._pos_encoding(tuple(x.shape[1:-1]), x.shape[-1],
                                    x.device)
            x = 0.5 * x + 0.5 * x2 + self._ffn(pe.to(x.dtype))
        return x, kv


class PatchMergingHW(nn.Module):
    """Halve H and W (vtunet_utils.py:823-860): the four (h, w) parities
    concatenated, ``norm``, ``reduction`` to twice the width."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, :, i::2, j::2, :]
                       for i, j in ((0, 0), (1, 0), (0, 1), (1, 1))], dim=-1)
        return self.reduction(self.norm(x))


class PatchExpandHW(nn.Module):
    """Double H and W, halve the width (vtunet_utils.py:939-996):
    ``expand`` to twice the width, each token's channels as a 2 x 2 block
    of half-width tokens, ``norm``."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 2, eps=1e-5)

    def forward(self, x):
        B, D, H, W, C = x.shape
        x = self.expand(x).view(B, D, H, W, 2, 2, C // 2)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, D, 2 * H, 2 * W, C // 2)
        return self.norm(x)


class FinalPatchExpand(nn.Module):
    """FinalPatchExpand_X4 (vtunet_utils.py:997-1058): ``expand`` by the
    patch volume, each token's channels as a patch of tokens of the same
    width, ``norm``."""

    def __init__(self, dim: int, patch_size: Sequence[int]):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.expand = nn.Linear(dim, math.prod(patch_size) * dim, bias=False)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        B, D, H, W, C = x.shape
        p1, p2, p3 = self.patch_size
        x = self.expand(x).view(B, D, H, W, p1, p2, p3, C)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(
            B, D * p1, H * p2, W * p3, C)
        return self.norm(x)


class PatchEmbed3D(nn.Module):
    """Non-overlapping patches by a strided conv (``proj``), then ``norm``;
    NCDHW in, (B, D, H, W, C) out."""

    def __init__(self, in_chan: int, embed_dim: int, patch_size):
        super().__init__()
        self.proj = nn.Conv3d(in_chan, embed_dim, patch_size,
                              stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 4, 1))


def _blocks(dim, depth, num_heads, window, dpr) -> nn.ModuleList:
    """A stage's blocks: unshifted, then shifted, alternating."""
    shift = tuple(w // 2 for w in window)
    return nn.ModuleList(
        SwinBlockVT(dim, num_heads, window, (0, 0, 0) if b % 2 == 0 else shift,
                    dpr[b])
        for b in range(depth))


class BasicLayer(nn.Module):
    """An encoder stage: ``blocks`` and the ``downsample`` merging (none
    after the last stage)."""

    def __init__(self, dim, depth, num_heads, window, dpr, downsample):
        super().__init__()
        self.blocks = _blocks(dim, depth, num_heads, window, dpr)
        self.downsample = PatchMergingHW(dim) if downsample else None


class BasicLayerUp(nn.Module):
    """A decoder stage: cross-attending ``blocks`` and the ``upsample``
    expansion (none after the last stage)."""

    def __init__(self, dim, depth, num_heads, window, dpr, upsample):
        super().__init__()
        self.blocks = _blocks(dim, depth, num_heads, window, dpr)
        self.upsample = PatchExpandHW(dim) if upsample else None


class SwinTransformerSys3D(nn.Module):
    """The encoder-decoder and its head (``swin_unet``): (B, C, D, H, W) ->
    the logits (B, classes, D, H, W)."""

    def __init__(self, in_chan, num_classes, patch_size, embed_dim, depths,
                 num_heads, window, drop_path_rate):
        super().__init__()
        nl = len(depths)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        start = [sum(depths[:i]) for i in range(nl)]
        self.patch_embed = PatchEmbed3D(in_chan, embed_dim, patch_size)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, depths[i], num_heads[i], window,
                       dpr[start[i]:start[i] + depths[i]], i < nl - 1)
            for i in range(nl))
        self.norm = nn.LayerNorm(embed_dim * 2 ** (nl - 1), eps=1e-5)
        # layers_up.0 is the bottleneck's expansion; stage inx (1..nl-1)
        # decodes encoder stage nl - 1 - inx, with its drop-path rates
        up = [PatchExpandHW(embed_dim * 2 ** (nl - 1))]
        back = [nn.Identity()]
        for inx in range(1, nl):
            s = nl - 1 - inx
            dim = embed_dim * 2 ** s
            back.append(nn.Linear(2 * dim, dim, bias=False))
            up.append(BasicLayerUp(dim, depths[s], num_heads[s], window,
                                   dpr[start[s]:start[s] + depths[s]],
                                   inx < nl - 1))
        self.layers_up = nn.ModuleList(up)
        self.concat_back_dim = nn.ModuleList(back)
        self.norm_up = nn.LayerNorm(embed_dim, eps=1e-5)
        self.up = FinalPatchExpand(embed_dim, patch_size)
        self.output = nn.Conv3d(embed_dim, num_classes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.patch_embed(x)
        skips, caches = [], []
        for layer in self.layers:
            skips.append(h)
            kv = [None, None]
            for b, blk in enumerate(layer.blocks):
                h, kv[b % 2] = blk(h)
            caches.append(kv)
            if layer.downsample is not None:
                h = layer.downsample(h)
        h = self.layers_up[0](self.norm(h))
        nl = len(self.layers)
        for inx in range(1, nl):
            s = nl - 1 - inx
            h = self.concat_back_dim[inx](torch.cat([h, skips[s]], dim=-1))
            layer = self.layers_up[inx]
            for b, blk in enumerate(layer.blocks):
                # even blocks attend to the unshifted cache, odd blocks to
                # the shifted one (vtunet_utils.py:1193-1197)
                h, _ = blk(h, caches[s][b % 2])
            if layer.upsample is not None:
                h = layer.upsample(h)
        h = self.up(self.norm_up(h))
        return self.output(h.permute(0, 4, 1, 2, 3))


class VTUNet(nn.Module):
    """The reference's VTUNet (``swin_unet``):
    logits (B, classes, D, H, W) in fp32 for an input whose extents are
    multiples of the patch size times 8 in H and W (three mergings)."""

    def __init__(self, in_chan: int, num_classes: int,
                 patch_size: Sequence[int] = (4, 4, 4),
                 embed_dim: int = EMBED_DIM,
                 depths: Sequence[int] = DEPTHS,
                 num_heads: Sequence[int] = NUM_HEADS,
                 window_size: Sequence[int] = WINDOW,
                 drop_path_rate: float = DROP_PATH_RATE):
        super().__init__()
        self.swin_unet = SwinTransformerSys3D(
            in_chan, num_classes, tuple(patch_size), embed_dim,
            tuple(depths), tuple(num_heads), tuple(window_size),
            drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.swin_unet(x).float()
