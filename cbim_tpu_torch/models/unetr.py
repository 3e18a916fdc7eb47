"""UNETR (Hatamizadeh et al., arXiv:2103.10504; counterpart of
``cbim_tpu/models/unetr.py``) and its decoder blocks, which SwinUNETR
shares, with MONAI's parameter names as
``cbim_tpu.utils.torch_import.import_unetr`` reads them.

- ``InstanceNormAffine``: instance norm with a learned scale and shift
  (``weight``, ``bias``), eps 1e-5, statistics in fp32;
- ``UnetResBlock``: conv-norm-LeakyReLU(0.01) twice with a residual, a 1^3
  conv + norm on the residual where the width changes (``conv1``/``norm1``,
  ``conv2``/``norm2``, ``conv3``/``norm3``);
- ``UnetrBasicBlock`` (``layer``), ``UnetrUpBlock`` (``transp_conv``, a
  2^3 stride-2 transposed conv, then ``conv_block`` on the concatenation
  with the skip) and ``UnetOutBlock`` (``conv``, 1^3 with bias).

These run on plain PyTorch ops (cuDNN convs, elementwise and reduction
kernels): the JAX package runs them in XLA, with no Pallas kernel.  Modules
take and return NCDHW tensors in ``channels_last_3d`` memory.

UNETR's backbone is a ViT (``vit``): 16^3 patches flattened in (pz, py,
px, C) order and embedded by a linear layer (``patch_embedding.proj``)
plus a learned position embedding sized by ``img_size``, so the model
runs at that input size only (another raises); pre-norm blocks
(``blocks.{i}``: ``norm1``, ``attn.qkv`` without bias split into q, k, v
thirds and each head-major, ``attn.out_proj``, ``norm2``,
``mlp.linear1``/``linear2`` with exact GELU); the final ``norm``.  The
decoder reads the tokens of blocks 3, 6 and 9 through transposed-conv
ladders (``encoder{2,3,4}``: ``transp_conv_init`` and ``blocks.{k}``,
2^3 stride 2, no bias) and the final tokens through ``decoder5``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import gelu

#: LeakyReLU slope and instance-norm eps of MONAI's dynunet blocks
LRELU_SLOPE = 0.01
NORM_EPS = 1e-5


class InstanceNormAffine(nn.Module):
    """Instance norm over the spatial axes with an affine scale and shift:
    y = (x - mean) / sqrt(var + eps) * weight + bias, biased variance in
    fp32, output in x.dtype; applied as one x * a + c pass, which keeps the
    input's memory format."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=tuple(range(2, x.dim())),
                                   unbiased=False, keepdim=True)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        a = torch.rsqrt(var + NORM_EPS) * self.weight.float().view(shape)
        c = self.bias.float().view(shape) - mean * a
        return torch.addcmul(c, x32, a).to(x.dtype)


class UnetResBlock(nn.Module):
    """MONAI's dynunet ``UnetResBlock`` (kernel 3, stride 1)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv3d(in_ch, out_ch, 3, padding=1, bias=False)
        self.norm1 = InstanceNormAffine(out_ch)
        self.conv2 = nn.Conv3d(out_ch, out_ch, 3, padding=1, bias=False)
        self.norm2 = InstanceNormAffine(out_ch)
        self.conv3 = self.norm3 = None
        if in_ch != out_ch:
            self.conv3 = nn.Conv3d(in_ch, out_ch, 1, bias=False)
            self.norm3 = InstanceNormAffine(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.norm1(self.conv1(x)), LRELU_SLOPE)
        out = self.norm2(self.conv2(out))
        res = x if self.conv3 is None else self.norm3(self.conv3(x))
        return F.leaky_relu(out + res, LRELU_SLOPE)


class UnetrBasicBlock(nn.Module):
    """An encoder block: one ``UnetResBlock`` named ``layer``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.layer = UnetResBlock(in_ch, out_ch)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """Upsample by a 2^3 stride-2 transposed conv (no bias), concatenate the
    skip after it, then a ``UnetResBlock``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.transp_conv = nn.ConvTranspose3d(in_ch, out_ch, 2, stride=2,
                                              bias=False)
        self.conv_block = UnetResBlock(2 * out_ch, out_ch)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class UnetOutBlock(nn.Module):
    """The 1^3 output conv (with bias), named ``conv``."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, num_classes, 1)

    def forward(self, x):
        return self.conv(x)


def _transp_conv(in_ch: int, out_ch: int) -> nn.ConvTranspose3d:
    """A 2^3 stride-2 transposed conv without bias (JAX ``_TranspConv``)."""
    return nn.ConvTranspose3d(in_ch, out_ch, 2, stride=2, bias=False)


class UnetrPrUpBlock(nn.Module):
    """The ViT taps' upsampling ladder (MONAI's UnetrPrUpBlock with
    conv_block=False): ``transp_conv_init``, then ``num_layer`` more
    transposed convs (``blocks``)."""

    def __init__(self, in_ch: int, out_ch: int, num_layer: int):
        super().__init__()
        self.transp_conv_init = _transp_conv(in_ch, out_ch)
        self.blocks = nn.ModuleList(_transp_conv(out_ch, out_ch)
                                    for _ in range(num_layer))

    def forward(self, x):
        x = self.transp_conv_init(x)
        for blk in self.blocks:
            x = blk(x)
        return x


#: the ViT's patch edge, its blocks, and the blocks whose tokens the
#: decoder reads besides the last (hidden_states[3, 6, 9])
PATCH = 16
VIT_LAYERS = 12
VIT_TAPS = (3, 6, 9)


class PatchEmbedding(nn.Module):
    """Non-overlapping 16^3 patches, flattened (pz, py, px, C), a linear
    embedding (``proj``) and ``position_embeddings`` (1, n, hidden) for the
    ``img_size`` grid."""

    def __init__(self, in_chan: int, img_size: Sequence[int], hidden: int):
        super().__init__()
        self.grid = tuple(s // PATCH for s in img_size)
        n = self.grid[0] * self.grid[1] * self.grid[2]
        self.proj = nn.Linear(PATCH ** 3 * in_chan, hidden)
        self.position_embeddings = nn.Parameter(torch.zeros(1, n, hidden))

    def forward(self, x):
        B, C = x.shape[:2]
        grid = tuple(s // PATCH for s in x.shape[2:])
        if grid != self.grid or any(s % PATCH for s in x.shape[2:]):
            raise ValueError(
                f"UNETR's position embedding is sized for a {self.grid} "
                f"patch grid ({tuple(g * PATCH for g in self.grid)} voxels, "
                f"the config's training_size); got an input of "
                f"{tuple(x.shape[2:])}")
        gd, gh, gw = grid
        x = x.reshape(B, C, gd, PATCH, gh, PATCH, gw, PATCH)
        x = x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(B, gd * gh * gw, -1)
        return self.proj(x) + self.position_embeddings


class SABlock(nn.Module):
    """Multi-head self-attention: ``qkv`` (no bias) split into q, k, v
    thirds, each (heads, dim_head) head-major; logits and softmax in fp32;
    ``out_proj``."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden, bias=False)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = (attn * q.shape[-1] ** -0.5).softmax(dim=-1).to(q.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class MLPBlock(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(hidden, mlp_dim)
        self.linear2 = nn.Linear(mlp_dim, hidden)

    def forward(self, x):
        return self.linear2(gelu(self.linear1(x)))


class TransformerBlock(nn.Module):
    """Pre-norm: x + attn(norm1(x)), then + mlp(norm2(x))."""

    def __init__(self, hidden: int, mlp_dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.attn = SABlock(hidden, heads)
        self.norm2 = nn.LayerNorm(hidden, eps=1e-5)
        self.mlp = MLPBlock(hidden, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """Patch embedding, ``VIT_LAYERS`` blocks, the final ``norm``; returns
    the normed final tokens and every block's output."""

    def __init__(self, in_chan: int, img_size: Sequence[int], hidden: int,
                 mlp_dim: int, heads: int):
        super().__init__()
        self.patch_embedding = PatchEmbedding(in_chan, img_size, hidden)
        self.blocks = nn.ModuleList(TransformerBlock(hidden, mlp_dim, heads)
                                    for _ in range(VIT_LAYERS))
        self.norm = nn.LayerNorm(hidden, eps=1e-5)

    def forward(self, x):
        x = self.patch_embedding(x)
        hidden = []
        for blk in self.blocks:
            x = blk(x)
            hidden.append(x)
        return self.norm(x), hidden


class UNETR(nn.Module):
    """The reference's model/dim3/unetr.py (feature size 16, hidden 768,
    MLP 3072, 12 heads as the factory builds it), at input ``img_size``
    (the config's training_size) only."""

    def __init__(self, in_chan: int, num_classes: int,
                 img_size: Sequence[int] = (96, 96, 96),
                 feature_size: int = 16, hidden_size: int = 768,
                 mlp_dim: int = 3072, num_heads: int = 12):
        super().__init__()
        f, h = feature_size, hidden_size
        self.vit = ViT(in_chan, img_size, h, mlp_dim, num_heads)
        self.encoder1 = UnetrBasicBlock(in_chan, f)
        self.encoder2 = UnetrPrUpBlock(h, 2 * f, 2)
        self.encoder3 = UnetrPrUpBlock(h, 4 * f, 1)
        self.encoder4 = UnetrPrUpBlock(h, 8 * f, 0)
        self.decoder5 = UnetrUpBlock(h, 8 * f)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f)
        self.decoder2 = UnetrUpBlock(2 * f, f)
        self.out = UnetOutBlock(f, num_classes)

    def forward(self, x):
        final, hidden = self.vit(x)
        grid = self.vit.patch_embedding.grid

        def volume(t):
            """tokens (B, N, hidden) -> NCDHW in channels-last memory"""
            return t.reshape(t.shape[0], *grid, -1).permute(0, 4, 1, 2, 3)

        e2, e3, e4 = (enc(volume(hidden[tap])) for enc, tap in zip(
            (self.encoder2, self.encoder3, self.encoder4), VIT_TAPS))
        out = self.decoder5(volume(final), e4)
        out = self.decoder4(out, e3)
        out = self.decoder3(out, e2)
        out = self.decoder2(out, self.encoder1(x))
        return self.out(out)
