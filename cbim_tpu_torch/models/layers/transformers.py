"""Transformer primitives (counterpart of
``cbim_tpu/models/layers/transformers.py``), with the reference's
trans_layers.py parameter names.  Attention logits and softmax run in fp32
under bf16 compute, as in ``cbim_tpu``.  Dropout sits where the JAX
package's does (the MLP after its activation and after its second linear,
the attention map after its softmax, and the output projection), drawn
from the train state's generator (``layers.convs.Dropout``).

The reference's dim3 attention merges its heads head-major on the way out,
its dim2 twin dim-head-major (einops ``b heads l dim_head -> b l (dim_head
heads)``, which ``import_medformer2d`` undoes with a column permutation of
``to_out``); ``dim_head_major`` selects the dim2 order.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.activations import get_act
from .convs import Dropout


class Mlp(nn.Module):
    """trans_layers.py:16-33 — fc1, act, dropout, fc2, dropout (``drop``,
    one module drawn twice)."""

    def __init__(self, in_dim, hid_dim=None, out_dim=None, act="gelu",
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hid_dim or in_dim)
        self.fc2 = nn.Linear(hid_dim or in_dim, out_dim or in_dim)
        self.act = get_act(act)
        self.drop = Dropout(drop)

    def forward(self, x):
        return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))


class Attention(nn.Module):
    """trans_layers.py:45-98 — multi-head self-attention on (B, L, C), with
    dropout of the attention map (``attn_drop``) and of the output
    projection (``proj_drop``)."""

    def __init__(self, dim, heads, dim_head, qkv_bias=False,
                 dim_head_major=False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.dim_head_major = dim_head_major
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=qkv_bias)
        self.to_out = nn.Linear(inner, dim)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x):
        b, l, _ = x.shape
        q, k, v = (t.reshape(b, l, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = (attn * self.dim_head ** -0.5).softmax(dim=-1).to(q.dtype)
        out = torch.matmul(self.attn_drop(attn), v)     # (b, heads, l, d)
        out = out.permute(0, 2, 3, 1) if self.dim_head_major \
            else out.transpose(1, 2)
        return self.proj_drop(self.to_out(out.reshape(b, l, -1)))


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class TransformerBlock(nn.Module):
    """trans_layers.py:101-118 — depth x (PreNorm MHSA + PreNorm MLP); the
    MLP's dropout rate is ``proj_drop``, as in JAX."""

    def __init__(self, dim, depth, heads, dim_head, mlp_dim,
                 dim_head_major=False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([PreNorm(dim, Attention(
                              dim, heads, dim_head,
                              dim_head_major=dim_head_major,
                              attn_drop=attn_drop, proj_drop=proj_drop)),
                           PreNorm(dim, Mlp(dim, mlp_dim, dim,
                                            drop=proj_drop))])
            for _ in range(depth))

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return x
