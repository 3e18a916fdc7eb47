"""TransUNet (Chen et al., arXiv:2102.04306; counterpart of
``cbim_tpu/models/transunet.py``), the R50-ViT-B/16 the reference builds
(model/dim2/transunet.py, the vendored official code), with its parameter
names, as ``cbim_tpu.utils.torch_import.import_transunet`` and the
official ``.npz`` loader (``utils/jax_import.py``
``transunet_npz_state_dict``) read them.

- ``transformer.embeddings.hybrid_model``: ResNetV2, blocks (3, 4, 9) at
  width 64: weight-standardised convs (``StdConv2d``: over (in, kh, kw),
  biased variance, eps 1e-5, every forward) and GroupNorm(32, eps 1e-6);
  a 7x7 stride-2 ``root``, a 3x3 stride-2 max-pool without padding (a 128
  map becomes 63), pre-activation bottlenecks (``gn_proj`` on the
  projected residual is GroupNorm(C, C) at torch's default eps 1e-5); the
  skips after block1 and block2 zero-padded at the bottom and right to
  1/4 and 1/8 of the input.
- The ViT-B/16 over the 1/16 features: a 1x1 patch conv
  (``patch_embeddings``) and learned ``position_embeddings`` for the
  ``grid`` (so the model runs at 16 times the grid only: another input
  raises), dropout; pre-LN blocks (``attention_norm``, ``attn.query``,
  ``key``, ``value``, ``out``, ``ffn_norm``, ``ffn.fc1``/``fc2`` with
  exact GELU and dropout after each), LayerNorm eps 1e-6, attention
  dropout 0; ``encoder_norm``.
- ``decoder`` (DecoderCup): ``conv_more`` to 512, then 4 blocks of
  bilinear x2 (align_corners=True), the skip concatenated after, and two
  conv-BatchNorm-ReLU (``conv1``, ``conv2``) to 256, 128, 64 and 16; the
  skips [512, 256, 64, none]; ``segmentation_head.0``, a 3x3 conv.
- A 1-channel input is tiled to 3.

Every conv here is a plain conv (cuDNN) and the BatchNorms follow Flax
(``layers.convs.Norm("bn")``, eps 1e-5): the JAX model runs them in XLA,
with no Pallas kernel.  Dropout draws its masks from the train state's
generator (``layers.convs.Dropout``, re-exported here), as ``DropPath``
does.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import gelu
from ..ops.interpolate import resize_linear
from .layers.convs import Dropout, Norm

#: the R50's blocks and width, the decoder's widths and skips
BLOCK_UNITS = (3, 4, 9)
WIDTH = 64
DECODER_CHANNELS = (256, 128, 64, 16)
N_SKIP = 3
#: the ViT-B/16's defaults (hidden, MLP, layers, heads, dropout)
HIDDEN_SIZE, MLP_DIM, NUM_LAYERS, NUM_HEADS, DROPOUT = 768, 3072, 12, 12, 0.1
#: the feature map's stride at the ViT
PATCH = 16


class StdConv2d(nn.Conv2d):
    """A conv whose weight is standardised every forward: (w - mean) /
    sqrt(var + 1e-5) over (in, kh, kw), biased variance."""

    def forward(self, x):
        w = self.weight
        var, mean = torch.var_mean(w, dim=(1, 2, 3), unbiased=False,
                                   keepdim=True)
        w = (w - mean) / torch.sqrt(var + 1e-5)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


def _std_conv(cin: int, cout: int, k: int, stride: int = 1) -> StdConv2d:
    return StdConv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False)


class PreActBottleneck(nn.Module):
    """relu(gn3(conv3(relu(gn2(conv2(relu(gn1(conv1(x))))))) + residual),
    the residual ``gn_proj(downsample(x))`` where the stride or the width
    changes."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.gn1 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv1 = _std_conv(cin, cmid, 1)
        self.gn2 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv2 = _std_conv(cmid, cmid, 3, stride)
        self.gn3 = nn.GroupNorm(32, cout, eps=1e-6)
        self.conv3 = _std_conv(cmid, cout, 1)
        self.downsample = self.gn_proj = None
        if stride != 1 or cin != cout:
            self.downsample = _std_conv(cin, cout, 1, stride)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x):
        residual = x
        if self.downsample is not None:
            residual = self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return F.relu(y + residual)


class ResNetV2(nn.Module):
    """The hybrid stem: returns the 1/16 features and the skips [1/8, 1/4,
    1/2] (the first two zero-padded to 1/8 and 1/4 of the input)."""

    def __init__(self, in_ch: int = 3, block_units=BLOCK_UNITS,
                 width: int = WIDTH):
        super().__init__()
        w = width
        self.root = nn.Sequential(OrderedDict(
            conv=_std_conv(in_ch, w, 7, 2),
            gn=nn.GroupNorm(32, w, eps=1e-6),
            relu=nn.ReLU()))
        blocks, cin = [], w
        for bi, (cout, cmid, stride) in enumerate(
                ((w * 4, w, 1), (w * 8, w * 2, 2), (w * 16, w * 4, 2))):
            units = []
            for u in range(block_units[bi]):
                units.append((f"unit{u + 1}", PreActBottleneck(
                    cin, cout, cmid, stride if u == 0 else 1)))
                cin = cout
            blocks.append((f"block{bi + 1}", nn.Sequential(OrderedDict(
                units))))
        self.body = nn.Sequential(OrderedDict(blocks))

    def forward(self, x):
        in_size = x.shape[2]
        x = self.root(x)
        features = [x]
        x = F.max_pool2d(x, 3, stride=2)
        for bi, block in enumerate(self.body):
            x = block(x)
            if bi < 2:
                right = in_size // 4 // (bi + 1)
                ph, pw = right - x.shape[2], right - x.shape[3]
                features.append(F.pad(x, (0, pw, 0, ph)) if ph or pw else x)
        return x, features[::-1]


class Embeddings(nn.Module):
    """The hybrid stem, the 1x1 patch conv, the position embedding of the
    ``grid`` and dropout."""

    def __init__(self, in_ch: int, grid: Sequence[int], hidden: int,
                 dropout: float):
        super().__init__()
        self.grid = tuple(int(g) for g in grid)
        self.hybrid_model = ResNetV2(in_ch)
        self.patch_embeddings = nn.Conv2d(WIDTH * 16, hidden, 1)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, self.grid[0] * self.grid[1], hidden))
        self.dropout = Dropout(dropout)

    def forward(self, x):
        feat, skips = self.hybrid_model(x)
        h = self.patch_embeddings(feat)
        if tuple(h.shape[2:]) != self.grid:
            raise ValueError(
                f"TransUNet's position embedding is sized for a {self.grid} "
                f"token grid ({tuple(g * PATCH for g in self.grid)} pixels, "
                f"the config's training_size); got an input of "
                f"{tuple(x.shape[2:])}")
        tokens = h.flatten(2).transpose(1, 2) + self.position_embeddings
        return self.dropout(tokens), skips


class Attention(nn.Module):
    """Multi-head self-attention with separate ``query``, ``key``,
    ``value`` and ``out`` Linears, heads split head-major; logits and
    softmax in fp32."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x):
        b, n, c = x.shape

        def split(t):
            return t.reshape(b, n, self.heads, -1).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = (attn * q.shape[-1] ** -0.5).softmax(dim=-1).to(q.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.out(out)


class Mlp(nn.Module):
    """fc1, exact GELU, dropout, fc2, dropout."""

    def __init__(self, hidden: int, mlp_dim: int, dropout: float):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.fc2(self.dropout(gelu(self.fc1(x)))))


class Block(nn.Module):
    """Pre-LN: x + attn(attention_norm(x)), then + ffn(ffn_norm(x))."""

    def __init__(self, hidden: int, mlp_dim: int, heads: int,
                 dropout: float):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.attn = Attention(hidden, heads)
        self.ffn_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn = Mlp(hidden, mlp_dim, dropout)

    def forward(self, x):
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class Encoder(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, num_layers: int,
                 heads: int, dropout: float):
        super().__init__()
        self.layer = nn.ModuleList(Block(hidden, mlp_dim, heads, dropout)
                                   for _ in range(num_layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=1e-6)

    def forward(self, x):
        for blk in self.layer:
            x = blk(x)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    def __init__(self, in_ch, grid, hidden, mlp_dim, num_layers, heads,
                 dropout):
        super().__init__()
        self.embeddings = Embeddings(in_ch, grid, hidden, dropout)
        self.encoder = Encoder(hidden, mlp_dim, num_layers, heads, dropout)

    def forward(self, x):
        tokens, skips = self.embeddings(x)
        return self.encoder(tokens), skips


def _conv_bn_relu(in_ch: int, out_ch: int) -> nn.Sequential:
    """A 3x3 conv without bias (``.0``), BatchNorm (``.1``), ReLU."""
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
                         Norm("bn", eps=1e-5, channels=out_ch), nn.ReLU())


class DecoderBlock(nn.Module):
    """Bilinear x2, the skip concatenated after, ``conv1`` and ``conv2``."""

    def __init__(self, in_ch: int, out_ch: int, skip_ch: int):
        super().__init__()
        self.conv1 = _conv_bn_relu(in_ch + skip_ch, out_ch)
        self.conv2 = _conv_bn_relu(out_ch, out_ch)

    def forward(self, x, skip=None):
        x = resize_linear(x, [2 * s for s in x.shape[2:]])
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class DecoderCup(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.conv_more = _conv_bn_relu(hidden, 512)
        in_chs = (512,) + DECODER_CHANNELS[:-1]
        skip_chs = (512, 256, 64, 0)[:N_SKIP] + (0,) * (4 - N_SKIP)
        self.blocks = nn.ModuleList(
            DecoderBlock(i, o, s)
            for i, o, s in zip(in_chs, DECODER_CHANNELS, skip_chs))

    def forward(self, tokens, grid, skips):
        b, _, c = tokens.shape
        x = self.conv_more(tokens.transpose(1, 2).reshape(b, c, *grid))
        for i, blk in enumerate(self.blocks):
            x = blk(x, skips[i] if i < N_SKIP else None)
        return x


class TransUNet(nn.Module):
    """The reference's model/dim2/transunet.py (R50-ViT-B/16 as the
    factory builds it: ``grid`` = the training size / 16), at that input
    size only; ``hidden_size``, ``mlp_dim``, ``num_layers``, ``num_heads``
    and ``dropout`` as the factory's config overrides give them."""

    def __init__(self, in_chan: int, num_classes: int,
                 grid: Sequence[int] = (14, 14),
                 hidden_size: int = HIDDEN_SIZE, mlp_dim: int = MLP_DIM,
                 num_layers: int = NUM_LAYERS, num_heads: int = NUM_HEADS,
                 dropout: float = DROPOUT):
        super().__init__()
        self.transformer = Transformer(3 if in_chan == 1 else in_chan, grid,
                                       hidden_size, mlp_dim, num_layers,
                                       num_heads, dropout)
        self.decoder = DecoderCup(hidden_size)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(DECODER_CHANNELS[-1], num_classes, 3, padding=1),
            nn.Identity())

    def forward(self, x):
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1).contiguous(
                memory_format=torch.channels_last)
        tokens, skips = self.transformer(x)
        y = self.decoder(tokens, self.transformer.embeddings.grid, skips)
        return self.segmentation_head(y)
