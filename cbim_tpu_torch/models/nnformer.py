"""nnFormer (Zhou et al., arXiv:2109.03201), counterpart of
``cbim_tpu/models/nnformer.py``: the reference's model/dim3/nnformer.py,
with its parameter names (``model_down.patch_embed.proj{1,2}.*``,
``model_down.layers.{i}.blocks.{b}.*``, ``.downsample.*``,
``model_down.norm{i}``, ``decoder.layers.{k}.Upsample.*``,
``decoder.layers.{k}.blocks.{b}.*``, ``final.{k}.up``), as
``cbim_tpu.utils.torch_import.import_nnformer3d`` reads them.

- A conv stem of two stages (conv 3^3 strided, GELU, LN, conv 3^3 [, GELU,
  LN]) to a patch of (2, 4, 4), then LN.
- Four encoder stages of Swin blocks with cubic windows (4, 4, 8, 4), each
  stage's output layer-normed as its skip; between stages a merging of
  GELU, LN and a stride-2 conv 3^3.
- Three decoder stages: LN and a 2^3 transposed conv, then a first block
  whose q is the upsampled path after ``norm1`` (no projection), whose k
  and v are projected (``attn.kv``) from the normed skip, with the residual
  on their sum; then shifted blocks.  The reference builds
  ``decoder.layers`` reversed: the coarsest stage is ``decoder.layers.2``.
- Deep supervision: three transposed-conv heads, resized trilinearly to
  the input, finest first (in eval mode too: serving and validation take
  head 0).

A block's window is nnFormer's rule (:func:`effective_window`), not the
Swin rule: when the grid's smallest extent is at most the window, the
window shrinks to that extent on every axis, the shift is dropped, and the
grid is padded.  The bias table is sized by the window of the crop the
model is built for (the reference fixes it from its input resolution), so
the model runs at that crop only.  The relative-position index keeps the
reference's colliding multipliers (:func:`nnformer_rel_index`).

Every window attention takes the route of ``swin_layers``: the kernel in
eval mode (14 launches a forward at the reference's depths), the autograd
route in training mode.  Stochastic depth (``DropPath``, rates a linspace
up to ``drop_path_rate`` over the encoder and separately over the decoder)
sits on both residuals of each block.  The convs stay cuDNN's, as they are
XLA's in the JAX package.

The model takes NCDHW in ``channels_last_3d`` memory; its token stages run
on (B, D, H, W, C) views.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.activations import gelu
from ..ops.interpolate import resize_linear
from .swin_layers import DropPath, ShiftedWindows, SwinMlp, attend

#: the reference's architecture (model/dim3/nnformer.py:889)
EMBED_DIM = 192
DEPTHS = (2, 2, 2, 2)
NUM_HEADS = (6, 12, 24, 48)
PATCH_SIZE = (2, 4, 4)
WINDOW = (4, 4, 8, 4)
DROP_PATH_RATE = 0.2


def nnformer_rel_index(window: Sequence[int]) -> np.ndarray:
    """The (N, N) bias-table index of nnFormer (nnformer.py:184-187): the
    offsets shifted by w - 1 and weighted by (3 w_1 - 1) and (2 w_1 - 1),
    both built on the second axis' w_1, so entries collide."""
    coords = np.stack(np.meshgrid(*[np.arange(w) for w in window],
                                  indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    for i in range(3):
        rel[:, :, i] += window[i] - 1
    rel[:, :, 0] *= 3 * window[1] - 1
    rel[:, :, 1] *= 2 * window[1] - 1
    return rel.sum(-1)


def effective_window(window: int, shift: int, spatial) -> tuple[int, int]:
    """nnFormer's window and shift for a grid of extent ``spatial``
    (nnformer.py:75-79): the smallest extent and no shift when it is at
    most the window, else the window and the shift."""
    if min(spatial) <= window:
        return min(spatial), 0
    return window, shift


def _ln_channels(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` over C of NCDHW ``x``, NCDHW out."""
    return norm(x.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)


class WindowAttentionNF(nn.Module):
    """nnFormer's window attention (``relative_position_bias_table``,
    ``qkv`` or, in the decoder's first block, ``kv``, and ``proj``) with
    its own bias index.  In kv mode q is the upsampled path's windows as
    they come; the kernel scales q k by D^-1/2 itself, which is nnFormer's
    scaling.  q, k and v are packed into one (b, n, 3, h, hd) tensor, the
    one set of strides the kernel stages."""

    def __init__(self, dim: int, num_heads: int, window: Sequence[int],
                 kv_mode: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(math.prod(2 * w - 1 for w in window), num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(nnformer_rel_index(window)), persistent=False)
        if kv_mode:
            self.kv = nn.Linear(dim, 2 * dim)
        else:
            self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, region: torch.Tensor | None = None,
                x_up: torch.Tensor | None = None) -> torch.Tensor:
        """x: (windows, N, C), the skip's in kv mode; x_up: the upsampled
        path's windows (kv mode only); region: int32 (num_windows, N) or
        None."""
        b, n, c = x.shape
        h = self.num_heads
        qkv = (self.qkv(x) if x_up is None
               else torch.cat([x_up, self.kv(x)], dim=-1))
        q, k, v = qkv.view(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, h).permute(
                2, 0, 1)
        out = attend(self.training, q, k, v, bias, region)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class NFBlock(ShiftedWindows):
    """SwinTransformerBlock and SwinTransformerBlock_kv (nnformer.py:62-154,
    310-399): ``norm1``, ``attn``, ``norm2``, ``mlp``, and one ``DropPath``
    on both residuals.  Built for a token grid of extent ``resolution``,
    which fixes its window (:func:`effective_window`) and bias table."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 resolution: Sequence[int], kv_mode: bool = False,
                 drop_path: float = 0.0):
        w, s = effective_window(window, shift, resolution)
        super().__init__((w,) * 3, (s,) * 3)
        self.nominal = (window, shift)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttentionNF(dim, num_heads, self.window_size,
                                      kv_mode)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = SwinMlp(dim)
        self.drop_path = DropPath(drop_path)

    def window_shift(self, spatial):
        w, s = effective_window(*self.nominal, spatial)
        if (w,) * 3 != self.window_size:
            raise ValueError(
                f"a {tuple(spatial)} token grid takes windows of {w}, but the "
                f"block's bias table is sized for {self.window_size}: "
                f"nnFormer runs at the crop it is built for")
        return self.window_size, (s,) * 3

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None,
                x_up: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, D, H, W, C); in kv mode x is x_up + skip, and the
        attention's q comes from ``x_up``, its k and v from ``skip``."""
        if skip is None:
            wins, region, layout = self.partition(self.norm1(x))
            out = self.attn(wins, region)
        else:
            wins, region, layout = self.partition(self.norm1(skip))
            q_wins, _, _ = self.partition(self.norm1(x_up))
            out = self.attn(wins, region, q_wins)
        x = x + self.drop_path(self.unpartition(out, layout))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class Project(nn.Module):
    """A stem stage (nnformer.py:629-660) on NCDHW: ``conv1`` (3^3,
    strided), GELU, ``norm1``, ``conv2`` (3^3), then GELU and ``norm2``
    unless it is the last."""

    def __init__(self, in_dim: int, out_dim: int, stride, last: bool):
        super().__init__()
        self.conv1 = nn.Conv3d(in_dim, out_dim, 3, stride=tuple(stride),
                               padding=1)
        self.norm1 = nn.LayerNorm(out_dim, eps=1e-5)
        self.conv2 = nn.Conv3d(out_dim, out_dim, 3, padding=1)
        self.norm2 = None if last else nn.LayerNorm(out_dim, eps=1e-5)

    def forward(self, x):
        x = self.conv2(_ln_channels(self.norm1, gelu(self.conv1(x))))
        if self.norm2 is not None:
            x = _ln_channels(self.norm2, gelu(x))
        return x


class PatchEmbed(nn.Module):
    """The conv stem (``proj1``, ``proj2``) and the patch ``norm``: NCDHW
    in, (B, D, H, W, C) out.  Strides (p0, p1/2, p2/2), then (p0/2, p1/2,
    p2/2)."""

    def __init__(self, in_chan: int, embed_dim: int, patch_size):
        super().__init__()
        p = tuple(patch_size)
        self.proj1 = Project(in_chan, embed_dim // 2,
                             (p[0], p[1] // 2, p[2] // 2), False)
        self.proj2 = Project(embed_dim // 2, embed_dim,
                             (max(p[0] // 2, 1), p[1] // 2, p[2] // 2), True)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj2(self.proj1(x)).permute(0, 2, 3, 4, 1))


class PatchMergingNF(nn.Module):
    """GELU, ``norm``, and ``reduction``, a stride-2 conv 3^3 to twice the
    width (nnformer.py:401-422), on (B, D, H, W, C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.reduction = nn.Conv3d(dim, 2 * dim, 3, stride=2, padding=1)

    def forward(self, x):
        x = self.norm(gelu(x)).permute(0, 4, 1, 2, 3)
        return self.reduction(x).permute(0, 2, 3, 4, 1)


class PatchExpandingNF(nn.Module):
    """``norm`` and ``up``, a 2^3 transposed conv to half the width
    (nnformer.py:424-446), on (B, D, H, W, C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.up = nn.ConvTranspose3d(dim, dim // 2, 2, stride=2)

    def forward(self, x):
        x = self.norm(x).permute(0, 4, 1, 2, 3)
        return self.up(x).permute(0, 2, 3, 4, 1)


class FinalExpand(nn.Module):
    """A head: ``up``, a transposed conv by the patch size to the classes;
    (B, D, H, W, C) in, NCDHW logits out."""

    def __init__(self, dim: int, num_classes: int, patch_size):
        super().__init__()
        self.up = nn.ConvTranspose3d(dim, num_classes, tuple(patch_size),
                                     stride=tuple(patch_size))

    def forward(self, x):
        return self.up(x.permute(0, 4, 1, 2, 3))


class EncoderLayer(nn.Module):
    """An encoder stage: ``blocks`` (unshifted, then shifted, alternating)
    and the ``downsample`` merging (none after the last stage)."""

    def __init__(self, dim, depth, num_heads, window, resolution, dpr,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            NFBlock(dim, num_heads, window, 0 if b % 2 == 0 else window // 2,
                    resolution, drop_path=dpr[b])
            for b in range(depth))
        self.downsample = PatchMergingNF(dim) if downsample else None


class DecoderLayer(nn.Module):
    """A decoder stage: ``Upsample`` from twice the width, then ``blocks``
    (the first in kv mode, unshifted; the rest alternating)."""

    def __init__(self, dim, depth, num_heads, window, resolution, dpr):
        super().__init__()
        self.Upsample = PatchExpandingNF(2 * dim)
        self.blocks = nn.ModuleList(
            NFBlock(dim, num_heads, window,
                    window // 2 if b % 2 else 0, resolution,
                    kv_mode=b == 0, drop_path=dpr[b])
            for b in range(depth))


class Encoder(nn.Module):
    """``model_down``: the stem, the stages and each stage's skip norm
    ``norm{i}``."""

    def __init__(self, in_chan, embed_dim, patch_size, depths, num_heads,
                 window_size, resolutions, drop_path_rate):
        super().__init__()
        nl = len(depths)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        start = [sum(depths[:i]) for i in range(nl)]
        self.patch_embed = PatchEmbed(in_chan, embed_dim, patch_size)
        self.layers = nn.ModuleList(
            EncoderLayer(embed_dim * 2 ** i, depths[i], num_heads[i],
                         window_size[i], resolutions[i],
                         dpr[start[i]:start[i] + depths[i]], i < nl - 1)
            for i in range(nl))
        for i in range(nl):
            self.add_module(f"norm{i}",
                            nn.LayerNorm(embed_dim * 2 ** i, eps=1e-5))

    def forward(self, x: torch.Tensor) -> list:
        h = self.patch_embed(x)
        skips = []
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                h = blk(h)
            skips.append(getattr(self, f"norm{i}")(h))
            if layer.downsample is not None:
                h = layer.downsample(h)
        return skips


class Decoder(nn.Module):
    """``decoder``: ``layers.{k}`` decodes encoder stage k, so the stage
    taken first (the coarsest) is ``layers.{nl - 2}``."""

    def __init__(self, embed_dim, depths, num_heads, window_size,
                 resolutions, drop_path_rate):
        super().__init__()
        nu = len(depths) - 1
        dec_depths = list(depths[::-1][1:])
        dpr = [float(v) for v in np.linspace(0, drop_path_rate,
                                             sum(dec_depths))]
        layers = {}
        for j in range(nu):
            k = nu - 1 - j
            start = sum(dec_depths[:j])
            layers[k] = DecoderLayer(
                embed_dim * 2 ** k, dec_depths[j], num_heads[k],
                window_size[k], resolutions[k],
                dpr[start:start + dec_depths[j]])
        self.layers = nn.ModuleList(layers[k] for k in range(nu))

    def forward(self, skips: list) -> list:
        """The outputs of each stage, coarsest first."""
        h = skips[-1]
        outs = []
        for k in reversed(range(len(self.layers))):
            layer = self.layers[k]
            x_up = layer.Upsample(h)
            skip = skips[k]
            h = layer.blocks[0](x_up + skip, skip=skip, x_up=x_up)
            for blk in layer.blocks[1:]:
                h = blk(h)
            outs.append(h)
        return outs


def stage_resolutions(crop_size, patch_size, n: int) -> list:
    """The token grid of each of ``n`` encoder stages for a crop: the
    stem's two strided convs (3^3, padding 1: ceil(x / stride) each), then
    halved by each merging (a stride-2 conv 3^3, padding 1)."""
    p = tuple(patch_size)
    strides = ((p[0], p[1] // 2, p[2] // 2),
               (max(p[0] // 2, 1), p[1] // 2, p[2] // 2))
    res = tuple(crop_size)
    for s in strides:
        res = tuple(-(-r // k) for r, k in zip(res, s))
    out = [res]
    for _ in range(n - 1):
        out.append(tuple(-(-r // 2) for r in out[-1]))
    return out


class NNFormer(nn.Module):
    """The reference's nnFormer (embedding 192, patch (2, 4, 4), windows
    (4, 4, 8, 4), heads (6, 12, 24, 48), depths (2, 2, 2, 2)) for crops of
    ``crop_size``: with ``deep_supervision`` the three heads' logits
    (B, classes, *crop), finest first, else the finest alone; fp32."""

    def __init__(self, in_chan: int, num_classes: int,
                 crop_size: Sequence[int] = (64, 128, 128),
                 embedding_dim: int = EMBED_DIM,
                 depths: Sequence[int] = DEPTHS,
                 num_heads: Sequence[int] = NUM_HEADS,
                 patch_size: Sequence[int] = PATCH_SIZE,
                 window_size: Sequence[int] = WINDOW,
                 deep_supervision: bool = True,
                 drop_path_rate: float = DROP_PATH_RATE):
        super().__init__()
        self.deep_supervision = deep_supervision
        res = stage_resolutions(crop_size, patch_size, len(depths))
        self.model_down = Encoder(in_chan, embedding_dim, patch_size, depths,
                                  num_heads, window_size, res,
                                  drop_path_rate)
        self.decoder = Decoder(embedding_dim, depths, num_heads, window_size,
                               res, drop_path_rate)
        heads = len(depths) - 1 if deep_supervision else 1
        self.final = nn.ModuleList(
            FinalExpand(embedding_dim * 2 ** i, num_classes, patch_size)
            for i in range(heads))

    def forward(self, x: torch.Tensor):
        outs = self.decoder(self.model_down(x))
        if not self.deep_supervision:
            return self.final[0](outs[-1]).float()
        n = len(outs)
        # final.{i} takes the stage of width embedding * 2^i: outs[n-1-i]
        return [resize_linear(self.final[i](outs[n - 1 - i]),
                              x.shape[2:]).float() for i in range(n)]
