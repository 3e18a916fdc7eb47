"""MedFormer (arXiv:2203.00131), counterpart of ``cbim_tpu/models/medformer.py``:
MedFormer-3D and MedFormer-2D, for serving and training.

Modules and parameter names follow the reference's model/dim3 and
model/dim2 medformer.py and medformer_utils.py, so
``cbim_tpu.utils.torch_import.import_medformer3d``/``import_medformer2d``
map this model's state_dict onto the Flax tree.  The shared blocks take
``nd``, the spatial rank.

The B-MHA splits its inner channels the reference's way, dim-head-major:
channel c = d * heads + h (medformer_utils.py rearrange, ``view(b,
dim_head, heads, -1)``).  ``cbim_tpu`` splits head-major and the importers
permute the weights for exactly that difference (``_bmha_perm``), so
copying the Flax split here would keep the names and change the numbers.

What differs between the ranks, as in the reference:
- the 2D model normalises with BatchNorm and ReLU everywhere, at torch's
  default eps 1e-5 (the 3D recipes use InstanceNorm);
- 2D ``PatchMerging`` orders its space-to-depth channels j-major;
- ``UpBlockMF2D`` applies norm + 1x1 reduction to the concatenation before
  its stage, and reduces the semantic map in every up block;
- the 2D map fusion merges its attention heads dim-head-major;
- 2D passes ``proj_drop`` on as the MBConv feed-forward's stochastic depth
  (``ffn_drop_path``), 3D does not.

``proj_type`` "depthwise" (the recipes') or "linear" picks the B-MHA's
feature projections and ``PatchMerging``'s reduction: depthwise-separable
k convs, or 1^d convs (``feat_qv``, ``feat_out``, ``reduction`` as plain
convs); under "linear" the B-MHA block's feed-forward is a
``FusedMBConv`` with 1^d kernels (no stochastic depth), as in JAX.
``attn_drop`` drops the map-to-feature attention (the softmax over the
features) and ``proj_drop`` the feature output after its projection, where
the JAX package drops them; the map fusion's transformer takes neither (the
JAX models build it without).  Both draw from the train state's generator.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.interpolate import resize_linear
from ..parallel.collectives import all_reduce_sum
from ..parallel.spatial import group_softmax
from .layers.convs import (CONV, ConvNormAct, DepthwiseSeparableConv,
                           Dropout, FusedMBConv, MBConv, Norm, _conv, _tuple,
                           from_channels_last, get_block_cls,
                           spatial_group, to_channels_last)
from .layers.transformers import TransformerBlock

#: per-stage remat modes (``cbim_tpu/models/medformer.py:573-603``): which
#: stages recompute their activations in the backward pass
REMAT_MODES = {           # inc, down1, down2-4, up3, up4, up1-2
    "all":           dict(inc=1, down1=1, low_d=1, up3=1, up4=1, low_u=1),
    "highres":       dict(inc=1, down1=1, low_d=0, up3=1, up4=1, low_u=0),
    "store-up4":     dict(inc=1, down1=1, low_d=1, up3=1, up4=0, low_u=1),
    "store-decoder": dict(inc=1, down1=1, low_d=1, up3=0, up4=0, low_u=0),
    "none":          dict(inc=0, down1=0, low_d=0, up3=0, up4=0, low_u=0),
}


def _conv1x1(in_ch, out_ch, bias=False, nd: int = 3):
    return CONV[nd](in_ch, out_ch, 1, bias=bias)


def _projection(in_ch, out_ch, kernel_size, proj_type, nd):
    """A B-MHA or PatchMerging projection: depthwise-separable k conv, or
    with ``proj_type`` "linear" a 1^d conv."""
    if proj_type == "linear":
        return _conv1x1(in_ch, out_ch, nd=nd)
    if proj_type != "depthwise":
        raise ValueError(f"unknown proj_type {proj_type!r}")
    return DepthwiseSeparableConv(in_ch, out_ch, kernel_size, nd=nd)


class BidirectionAttention(nn.Module):
    """Feature <-> semantic-map cross attention, both directions."""

    def __init__(self, feat_dim, map_dim, out_dim, heads=4, dim_head=64,
                 kernel_size=3, no_map_out=False, nd: int = 3,
                 proj_type: str = "depthwise", attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.feat_qv = _projection(feat_dim, inner * 2, kernel_size,
                                   proj_type, nd)
        self.map_qv = _conv1x1(map_dim, inner * 2, nd=nd)
        self.feat_out = _projection(inner, out_dim, kernel_size, proj_type,
                                    nd)
        self.map_out = None if no_map_out else _conv1x1(inner, map_dim, nd=nd)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        #: H-sharded training (``layers.convs.spatial_shard``): the
        #: map-to-feature softmax and its sum run over every slab's tokens
        self.spatial_group = None

    def _to_heads(self, t):
        """(B, inner, *spatial), channel d*heads + h -> (B, heads, N, d)."""
        return t.reshape(t.shape[0], self.dim_head, self.heads,
                         -1).permute(0, 2, 3, 1)

    def _from_heads(self, t, spatial):
        """(B, heads, N, d) -> (B, inner, *spatial), channel d*heads + h."""
        b = t.shape[0]
        return t.permute(0, 3, 1, 2).reshape(b, -1, *spatial)

    def forward(self, feat, semantic_map):
        fq, fv = (self._to_heads(t) for t in self.feat_qv(feat).chunk(2, 1))
        mq, mv = (self._to_heads(t)
                  for t in self.map_qv(semantic_map).chunk(2, 1))
        attn = torch.matmul(fq.float(), mq.float().transpose(-1, -2))
        attn = attn * self.dim_head ** -0.5                # (B, h, N, M)
        feat_map_attn = attn.softmax(dim=-1).to(fq.dtype)
        group = spatial_group(self)
        feat_out = torch.matmul(feat_map_attn, mv)         # (B, h, N, d)
        feat_out = self.proj_drop(self.feat_out(
            self._from_heads(feat_out, feat.shape[2:])))
        if self.map_out is None:
            return feat_out, None
        if group is None:
            map_feat_attn = attn.softmax(dim=-2).to(fq.dtype)
        else:       # over the N tokens of every slab
            map_feat_attn = group_softmax(attn, -2, group).to(fq.dtype)
        map_out = torch.matmul(self.attn_drop(map_feat_attn).transpose(-1, -2),
                               fv)
        if group is not None:
            # the sum over every slab's tokens: each peer holds the map
            map_out = all_reduce_sum(map_out.float(), group).to(map_out.dtype)
        return feat_out, self.map_out(
            self._from_heads(map_out, semantic_map.shape[2:]))


class BidirectionAttentionBlock(nn.Module):
    """norm -> B-MHA -> shortcut -> feedforward (MBConv, or FusedMBConv
    with 1^d kernels under ``proj_type`` "linear"); map residual.
    ``ffn_drop_path``: the MBConv's stochastic depth.  The map's norm
    (``norm2``) normalises the semantic map, which every spatial peer holds
    whole."""

    replicated = ("norm2",)

    def __init__(self, feat_dim, map_dim, out_dim, heads, dim_head, norm="in",
                 act="relu", expansion=4, kernel_size=3, no_map_out=False,
                 nd: int = 3, proj_type: str = "depthwise",
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 ffn_drop_path: float = 0.0):
        super().__init__()
        # the reference builds these norms with torch's default eps 1e-5
        self.norm1 = Norm(norm, eps=1e-5, channels=feat_dim)
        self.norm2 = Norm(norm, eps=1e-5, channels=map_dim)
        self.attn = BidirectionAttention(feat_dim, map_dim, out_dim, heads,
                                         dim_head, kernel_size, no_map_out,
                                         nd=nd, proj_type=proj_type,
                                         attn_drop=attn_drop,
                                         proj_drop=proj_drop)
        self.shortcut = (ConvNormAct(feat_dim, out_dim, 1, norm=norm,
                                     act=act, preact=True, nd=nd)
                         if feat_dim != out_dim else None)
        if proj_type == "linear":
            self.feedforward = FusedMBConv(out_dim, out_dim, 1, norm=norm,
                                           act=act, nd=nd,
                                           expansion=expansion)
        else:
            self.feedforward = MBConv(out_dim, out_dim, kernel_size,
                                      norm=norm, act=act, nd=nd,
                                      expansion=expansion, p=ffn_drop_path)

    def forward(self, x, semantic_map):
        out, map_out = self.attn(self.norm1(x), self.norm2(semantic_map))
        out = out + (x if self.shortcut is None else self.shortcut(x))
        out = self.feedforward(out)
        if map_out is None:
            return out, None
        return out, map_out + semantic_map


class PatchMerging(nn.Module):
    """Space-to-depth downsample + norm + reduction (depthwise-separable,
    or a 1^d conv under ``proj_type`` "linear")."""

    def __init__(self, in_ch, out_ch, down_scale=2, kernel_size=3, norm="in",
                 nd: int = 3, proj_type: str = "depthwise"):
        super().__init__()
        self.scale = _tuple(down_scale, nd)
        merged = in_ch * math.prod(self.scale)
        # torch-default eps (reference PatchMerging norm)
        self.norm = Norm(norm, eps=1e-5, channels=merged)
        self.reduction = _projection(merged, out_ch, kernel_size, proj_type,
                                     nd)

    def forward(self, x):
        t = to_channels_last(x)
        if t.dim() == 5:
            # out channel = ((i * s1 + j) * s2 + k) * C + c, the reference's
            # nested concat order (cbim_tpu/models/medformer.py:180-191)
            s0, s1, s2 = self.scale
            B, D, H, W, C = t.shape
            t = t.reshape(B, D // s0, s0, H // s1, s1, W // s2, s2, C)
            t = t.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
                B, D // s0, H // s1, W // s2, s0 * s1 * s2 * C)
        else:
            # dim2 order (0,0), (1,0), (0,1), (1,1): j-major,
            # out channel = (j * s0 + i) * C + c (medformer.py:192-198)
            s0, s1 = self.scale
            B, H, W, C = t.shape
            t = t.reshape(B, H // s0, s0, W // s1, s1, C)
            t = t.permute(0, 1, 3, 4, 2, 5).reshape(
                B, H // s0, W // s1, s0 * s1 * C)
        return self.reduction(self.norm(from_channels_last(t)))


class BasicLayer(nn.Module):
    """``num_blocks`` B-MHA blocks of one stage (``bmha``: their
    ``proj_type``, ``attn_drop``, ``proj_drop`` and ``ffn_drop_path``)."""

    def __init__(self, feat_dim, map_dim, out_dim, num_blocks, heads=4,
                 dim_head=64, expansion=4, norm="in", act="relu",
                 kernel_size=3, no_map_out=False, nd: int = 3, **bmha):
        super().__init__()
        self.blocks = nn.ModuleList(
            BidirectionAttentionBlock(
                feat_dim if i == 0 else out_dim, map_dim, out_dim, heads,
                dim_head, norm=norm, act=act, expansion=expansion,
                kernel_size=kernel_size,
                no_map_out=no_map_out and i == num_blocks - 1, nd=nd,
                **bmha)
            for i in range(num_blocks))

    def forward(self, x, semantic_map):
        for blk in self.blocks:
            x, semantic_map = blk(x, semantic_map)
        return x, semantic_map


class SemanticMapGeneration(nn.Module):
    """Spatial-softmax pooled semantic map (medformer_utils.py:203-228)."""

    def __init__(self, feat_dim, map_dim, map_size):
        super().__init__()
        self.map_size = tuple(map_size)
        conv = CONV[len(self.map_size)]
        self.base_proj = conv(feat_dim, map_dim, 3, padding=1, bias=False)
        self.semantic_proj = conv(feat_dim, math.prod(self.map_size), 3,
                                  padding=1, bias=False)

        #: H-sharded training (``layers.convs.spatial_shard``): the softmax
        #: and the sum run over every slab's voxels, so every peer holds the
        #: whole map
        self.spatial_group = None

    def forward(self, x):
        b = x.shape[0]
        feat = _conv(self.base_proj, x).reshape(b, -1, math.prod(x.shape[2:]))
        weight = _conv(self.semantic_proj, x).reshape(b, -1, feat.shape[-1])
        group = spatial_group(self)
        if group is None:
            weight = weight.float().softmax(dim=-1).to(feat.dtype)  # space
            smap = torch.bmm(feat, weight.transpose(1, 2))      # (B, C, K)
        else:       # over every slab's voxels
            weight = group_softmax(weight.float(), -1, group).to(feat.dtype)
            smap = all_reduce_sum(torch.bmm(feat, weight.transpose(1, 2))
                                  .float(), group).to(feat.dtype)
        return smap.reshape(b, -1, *self.map_size)


class SemanticMapFusion(nn.Module):
    """Cross-scale transformer over the concatenated maps
    (medformer_utils.py:231-261)."""

    def __init__(self, in_dims, dim, heads, depth=1, nd: int = 3):
        super().__init__()
        self.depth = depth
        self.in_proj = nn.ModuleList(_conv1x1(d, dim, nd=nd) for d in in_dims)
        self.fusion = TransformerBlock(dim, depth, heads, dim // heads, dim,
                                       dim_head_major=nd == 2)
        self.out_proj = nn.ModuleList(_conv1x1(dim, d, nd=nd) for d in in_dims)

    def forward(self, map_list):
        if self.depth == 0:
            return map_list
        spatial = map_list[0].shape[2:]
        seq = torch.cat([proj(m).flatten(2).transpose(1, 2)
                         for proj, m in zip(self.in_proj, map_list)], dim=1)
        seq = self.fusion(seq)
        outs = seq.chunk(len(map_list), dim=1)
        return [proj(o.transpose(1, 2).reshape(o.shape[0], -1, *spatial))
                for proj, o in zip(self.out_proj, outs)]


class InConvMF(nn.Module):
    """conv + block (medformer_utils.py:264-277)."""

    def __init__(self, in_ch, out_ch, conv_block, kernel_size=3, norm="in",
                 act="relu", nd: int = 3, conv_na: bool = False,
                 conv2d_kernel: bool = False):
        super().__init__()
        k = _tuple(kernel_size, nd)
        self.conv1 = CONV[nd](in_ch, out_ch, k,
                              padding=tuple(ki // 2 for ki in k), bias=False)
        self.conv2 = get_block_cls(conv_block)(out_ch, out_ch,
                                               kernel_size=kernel_size,
                                               norm=norm, act=act, nd=nd,
                                               conv_na=conv_na,
                                               conv2d_kernel=conv2d_kernel)

    def forward(self, x):
        return self.conv2(_conv(self.conv1, x))


class DownBlockMF(nn.Module):
    """PatchMerging -> conv blocks -> (map generation) -> B-MHA blocks
    (``bmha``: :class:`BasicLayer`'s)."""

    def __init__(self, in_ch, out_ch, conv_num, trans_num,
                 conv_block="BasicBlock", kernel_size=3, down_scale=2,
                 heads=4, dim_head=64, expansion=4, map_size=(4, 4, 4),
                 norm="in", act="relu", map_generate=False, nd: int = 3,
                 conv_na: bool = False, conv2d_kernel: bool = False,
                 **bmha):
        super().__init__()
        self.patch_merging = PatchMerging(
            in_ch, out_ch, down_scale, kernel_size, norm, nd=nd,
            proj_type=bmha.get("proj_type", "depthwise"))
        blk = get_block_cls(conv_block)
        self.conv_blocks = nn.Sequential(*(
            blk(out_ch, out_ch, kernel_size=kernel_size, norm=norm, act=act,
                nd=nd, conv_na=conv_na, conv2d_kernel=conv2d_kernel)
            for _ in range(conv_num)))
        self.map_gen = (SemanticMapGeneration(out_ch, out_ch, map_size)
                        if map_generate else None)
        self.trans_blocks = (
            BasicLayer(out_ch, out_ch, out_ch, trans_num, heads, dim_head,
                       expansion, norm, act, kernel_size, nd=nd, **bmha)
            if trans_num > 0 else None)

    def forward(self, x):
        x = self.conv_blocks(self.patch_merging(x))
        semantic_map = self.map_gen(x) if self.map_gen is not None else None
        if self.trans_blocks is not None:
            x, semantic_map = self.trans_blocks(x, semantic_map)
        return x, semantic_map


class UpBlockMF3D(nn.Module):
    """dim3 medformer_utils.py:320-370: resize + concat feed the stage."""

    def __init__(self, in_ch, skip_ch, out_ch, conv_num, trans_num,
                 conv_block="BasicBlock", kernel_size=3, heads=4, dim_head=64,
                 expansion=4, norm="in", act="relu", map_in_dim=None,
                 no_map_out=False, conv_na: bool = False, **bmha):
        super().__init__()
        # map_in_dim: channels of the concatenated map shortcut, if any
        self.map_reduction = (_conv1x1(map_in_dim, out_ch)
                              if map_in_dim is not None else None)
        feat_dim = in_ch + skip_ch
        self.trans_blocks = (
            BasicLayer(feat_dim, out_ch, out_ch, trans_num, heads, dim_head,
                       expansion, norm, act, kernel_size,
                       no_map_out=no_map_out, **bmha)
            if trans_num > 0 else None)
        blk = get_block_cls(conv_block)
        first = out_ch if trans_num > 0 else feat_dim
        self.conv_blocks = nn.Sequential(*(
            blk(first if j == 0 else out_ch, out_ch, kernel_size=kernel_size,
                norm=norm, act=act, conv_na=conv_na)
            for j in range(conv_num)))
        #: H-sharded training (``layers.convs.spatial_shard``)
        self.spatial_group = None

    def forward(self, x_low, x_skip, map1, map2=None):
        x_low = resize_linear(x_low, x_skip.shape[2:], spatial_group(self))
        if self.map_reduction is not None and map2 is not None:
            semantic_map = self.map_reduction(torch.cat([map1, map2], dim=1))
        else:
            semantic_map = map1
        out = torch.cat([x_low, x_skip], dim=1)
        if self.trans_blocks is not None:
            out, semantic_map = self.trans_blocks(out, semantic_map)
        return self.conv_blocks(out), semantic_map


class UpBlockMF2D(nn.Module):
    """dim2 medformer_utils.py:298-349: resize + concat, then norm + 1x1
    ``reduction`` to ``out_ch`` before the stage; the semantic map (with
    the map shortcut concatenated, if any) goes through a 1x1
    ``map_reduction`` in every up block."""

    def __init__(self, in_ch, skip_ch, out_ch, conv_num, trans_num,
                 map_in_dim, conv_block="BasicBlock", heads=4, dim_head=64,
                 expansion=4, norm="bn", act="relu",
                 conv2d_kernel: bool = False, **bmha):
        super().__init__()
        # reference up_block norm(in_ch + out_ch), torch-default eps
        self.norm = Norm(norm, eps=1e-5, channels=in_ch + skip_ch)
        self.reduction = _conv1x1(in_ch + skip_ch, out_ch, nd=2)
        self.map_reduction = _conv1x1(map_in_dim, out_ch, nd=2)
        self.trans_blocks = (
            BasicLayer(out_ch, out_ch, out_ch, trans_num, heads, dim_head,
                       expansion, norm, act, nd=2, **bmha)
            if trans_num > 0 else None)
        blk = get_block_cls(conv_block)
        self.conv_blocks = nn.Sequential(*(
            blk(out_ch, out_ch, norm=norm, act=act, nd=2,
                conv2d_kernel=conv2d_kernel)
            for _ in range(conv_num)))

    def forward(self, x_low, x_skip, map1, map2=None):
        x_low = resize_linear(x_low, x_skip.shape[2:])
        out = self.reduction(self.norm(torch.cat([x_low, x_skip], dim=1)))
        semantic_map = map1 if map2 is None else torch.cat([map1, map2], 1)
        semantic_map = self.map_reduction(semantic_map)
        if self.trans_blocks is not None:
            out, semantic_map = self.trans_blocks(out, semantic_map)
        return self.conv_blocks(out), semantic_map


class MedFormer3D(nn.Module):
    """Reference model/dim3/medformer.py:11.  forward: x (B, in_chan, D, H,
    W) -> logits (B, classes, D, H, W) in fp32, or [logits, aux] with
    ``aux_loss``.

    ``remat`` (False | True/'all' | 'highres' | 'store-up4' |
    'store-decoder' | 'none') checkpoints the stages that
    :data:`REMAT_MODES` names, in ``train()`` mode only; their forward runs
    again in the backward pass.  ``conv_na`` computes every preact
    InstanceNorm 3^3 conv of the conv blocks as one fused
    ``ConvInormAct3d`` (the JAX package's opt-in ``CBIM_CONV_NA=1``); the
    parameters are the same either way.  ``proj_type``, ``attn_drop`` and
    ``proj_drop`` reach every B-MHA block (the module docstring).  Under
    H sharding (``layers.convs.spatial_shard``) the map fusion runs on the
    semantic maps every spatial peer holds whole."""

    replicated = ("map_fusion",)

    def __init__(self, in_chan: int, num_classes: int, base_ch: int = 32,
                 map_size: Sequence[int] = (4, 8, 8),
                 conv_block: str = "BasicBlock",
                 conv_num: Sequence[int] = (2, 1, 0, 0, 0, 1, 2, 2),
                 trans_num: Sequence[int] = (0, 1, 2, 2, 2, 1, 0, 0),
                 chan_num: Sequence[int] = (64, 128, 256, 320, 256, 128, 64,
                                            32),
                 num_heads: Sequence[int] = (1, 4, 8, 16, 8, 4, 1, 1),
                 fusion_depth: int = 2, fusion_dim: int = 320,
                 fusion_heads: int = 4, expansion: int = 4,
                 proj_type: str = "depthwise", norm="in", act="gelu",
                 kernel_size: Sequence = ((3, 3, 3),) * 5,
                 scale: Sequence = ((2, 2, 2),) * 4, aux_loss: bool = False,
                 remat: Any = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, conv_na: bool = False):
        super().__init__()
        mode = "all" if remat is True else (remat or "none")
        if mode not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}")
        self.remat = REMAT_MODES[mode]
        cn = list(chan_num)
        dim_head = [cn[i] // num_heads[i] for i in range(8)]
        ks = list(kernel_size)
        common = dict(conv_block=conv_block, expansion=expansion,
                      norm=norm, act=act, conv_na=conv_na,
                      proj_type=proj_type, attn_drop=attn_drop,
                      proj_drop=proj_drop)

        self.inc = InConvMF(in_chan, base_ch, conv_block, ks[0], norm, act,
                            conv_na=conv_na)
        self.down1 = DownBlockMF(base_ch, cn[0], conv_num[0], trans_num[0],
                                 kernel_size=ks[1], down_scale=scale[0],
                                 map_size=map_size, **common)
        downs = []
        for i in (1, 2, 3):
            downs.append(DownBlockMF(
                cn[i - 1], cn[i], conv_num[i], trans_num[i],
                kernel_size=ks[i + 1], down_scale=scale[i],
                heads=num_heads[i], dim_head=dim_head[i], map_size=map_size,
                map_generate=True, **common))
        self.down2, self.down3, self.down4 = downs

        self.map_fusion = SemanticMapFusion(cn[1:4], fusion_dim, fusion_heads,
                                            fusion_depth)

        self.up1 = UpBlockMF3D(cn[3], cn[2], cn[4], conv_num[4], trans_num[4],
                               kernel_size=ks[3], heads=num_heads[4],
                               dim_head=dim_head[4],
                               map_in_dim=cn[3] + cn[2], **common)
        self.up2 = UpBlockMF3D(cn[4], cn[1], cn[5], conv_num[5], trans_num[5],
                               kernel_size=ks[2], heads=num_heads[5],
                               dim_head=dim_head[5],
                               map_in_dim=cn[4] + cn[1], no_map_out=True,
                               **common)
        self.up3 = UpBlockMF3D(cn[5], cn[0], cn[6], conv_num[6], trans_num[6],
                               kernel_size=ks[1], **common)
        self.up4 = UpBlockMF3D(cn[6], base_ch, cn[7], conv_num[7],
                               trans_num[7], kernel_size=ks[0], **common)

        self.aux_out = _conv1x1(cn[5], num_classes, bias=True) \
            if aux_loss else None
        self.outc = _conv1x1(cn[7], num_classes, bias=True)
        #: H-sharded training (``layers.convs.spatial_shard``): the aux
        #: head's upsample
        self.spatial_group = None

    def _stage(self, key: str, module: nn.Module, *args):
        """``module(*args)``, recomputed in the backward pass when training
        with ``key``'s stages under remat.  The recompute draws the same
        dropout masks as the forward did (as JAX's remat replays its
        keys): the generators of the stage's stochastic modules are
        rewound to their state at the forward for it, and put back after."""
        if not (self.training and self.remat[key]):
            return module(*args)
        gens = list({id(m.generator): m.generator for m in module.modules()
                     if getattr(m, "generator", None) is not None
                     and getattr(m, "p", 0)}.values())
        start = [g.get_state() for g in gens]
        calls = []

        def run(*a):
            calls.append(1)
            if len(calls) == 1:
                return module(*a)
            now = [g.get_state() for g in gens]
            for g, state in zip(gens, start):
                g.set_state(state)
            try:
                return module(*a)
            finally:
                for g, state in zip(gens, now):
                    g.set_state(state)

        return checkpoint(run, *args, use_reentrant=False)

    def forward(self, x):
        x0 = self._stage("inc", self.inc, x)
        x1, _ = self._stage("down1", self.down1, x0)
        x2, map2 = self._stage("low_d", self.down2, x1)
        x3, map3 = self._stage("low_d", self.down3, x2)
        x4, map4 = self._stage("low_d", self.down4, x3)

        map_list = self.map_fusion([map2, map3, map4])

        out, smap = self._stage("low_u", self.up1, x4, x3, map_list[2],
                                map_list[1])
        out, smap = self._stage("low_u", self.up2, out, x2, smap, map_list[0])
        aux = (resize_linear(self.aux_out(out), x.shape[2:],
                             spatial_group(self)).float()
               if self.aux_out is not None else None)

        out, smap = self._stage("up3", self.up3, out, x1, smap, None)
        out, smap = self._stage("up4", self.up4, out, x0, smap, None)
        out = self.outc(out).float()
        return out if aux is None else [out, aux]


class MedFormer2D(nn.Module):
    """Reference model/dim2/medformer.py:10 (``cbim_tpu``'s MedFormer2D).
    forward: x (B, in_chan, H, W) -> logits (B, classes, H, W) in fp32, or
    [logits, aux] with ``aux_loss``.

    Stage widths follow ``base_ch``: [2, 4, 8, 16, 8, 4, 2, 1] x base_ch;
    3x3 kernels and 2x2 downsampling throughout; BatchNorm + ReLU by
    default, no remat (the JAX model has none).  ``conv2d_kernel`` sends
    the conv blocks' eligible 3x3 convs through ``Conv2dSame`` (the JAX
    package's opt-in ``CBIM_PLCONV2D=1``); off, they are cuDNN's.  The
    parameters are the same either way.  ``proj_type``, ``attn_drop`` and
    ``proj_drop`` reach every B-MHA block, and ``proj_drop`` is also the
    stochastic depth of their MBConv feed-forwards (JAX's
    ``ffn_drop_path``)."""

    def __init__(self, in_chan: int, num_classes: int, base_ch: int = 32,
                 map_size: Any = 8, conv_block: str = "BasicBlock",
                 conv_num: Sequence[int] = (2, 1, 0, 0, 0, 1, 2, 2),
                 trans_num: Sequence[int] = (0, 1, 2, 2, 2, 1, 0, 0),
                 num_heads: Sequence[int] = (1, 4, 8, 16, 8, 4, 1, 1),
                 fusion_depth: int = 2, fusion_dim: int = 512,
                 fusion_heads: int = 16, expansion: int = 4,
                 proj_type: str = "depthwise", norm="bn", act="relu",
                 aux_loss: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, conv2d_kernel: bool = False):
        super().__init__()
        b = base_ch
        cn = [2 * b, 4 * b, 8 * b, 16 * b, 8 * b, 4 * b, 2 * b, b]
        dim_head = [cn[i] // num_heads[i] for i in range(8)]
        map_size = ((map_size,) * 2 if isinstance(map_size, int)
                    else tuple(map_size))
        common = dict(conv_block=conv_block, expansion=expansion, norm=norm,
                      act=act, conv2d_kernel=conv2d_kernel,
                      proj_type=proj_type, attn_drop=attn_drop,
                      proj_drop=proj_drop, ffn_drop_path=proj_drop)

        self.inc = InConvMF(in_chan, b, conv_block, 3, norm, act, nd=2,
                            conv2d_kernel=conv2d_kernel)
        self.down1 = DownBlockMF(b, cn[0], conv_num[0], trans_num[0],
                                 map_size=map_size, nd=2, **common)
        downs = []
        for i in (1, 2, 3):
            downs.append(DownBlockMF(
                cn[i - 1], cn[i], conv_num[i], trans_num[i],
                heads=num_heads[i], dim_head=dim_head[i], map_size=map_size,
                map_generate=True, nd=2, **common))
        self.down2, self.down3, self.down4 = downs

        self.map_fusion = SemanticMapFusion(cn[1:4], fusion_dim, fusion_heads,
                                            fusion_depth, nd=2)

        self.up1 = UpBlockMF2D(cn[3], cn[2], cn[4], conv_num[4], trans_num[4],
                               map_in_dim=cn[3] + cn[2], heads=num_heads[4],
                               dim_head=dim_head[4], **common)
        self.up2 = UpBlockMF2D(cn[4], cn[1], cn[5], conv_num[5], trans_num[5],
                               map_in_dim=cn[4] + cn[1], heads=num_heads[5],
                               dim_head=dim_head[5], **common)
        self.up3 = UpBlockMF2D(cn[5], cn[0], cn[6], conv_num[6], trans_num[6],
                               map_in_dim=cn[5], **common)
        self.up4 = UpBlockMF2D(cn[6], b, cn[7], conv_num[7], trans_num[7],
                               map_in_dim=cn[6], **common)

        self.aux_out = (_conv1x1(cn[5], num_classes, bias=True, nd=2)
                        if aux_loss else None)
        self.outc = _conv1x1(cn[7], num_classes, bias=True, nd=2)

    def forward(self, x):
        x0 = self.inc(x)
        x1, _ = self.down1(x0)
        x2, map2 = self.down2(x1)
        x3, map3 = self.down3(x2)
        x4, map4 = self.down4(x3)

        map_list = self.map_fusion([map2, map3, map4])

        out, smap = self.up1(x4, x3, map_list[2], map_list[1])
        out, smap = self.up2(out, x2, smap, map_list[0])
        aux = (resize_linear(self.aux_out(out), x.shape[2:]).float()
               if self.aux_out is not None else None)

        out, smap = self.up3(out, x1, smap)
        out, smap = self.up4(out, x0, smap)
        out = self.outc(out).float()
        return out if aux is None else [out, aux]
