"""Flax MedFormer-3D params -> this port's state_dict.

The exact inverse of ``cbim_tpu.utils.torch_import.import_medformer3d``:
the same walk over the tree, with each layout transform undone

    conv:   (*k, I, O) -> (O, I, *k)
    linear: (I, O)     -> (O, I)

and each B-MHA channel permutation (``_bmha_perm``: Flax splits the inner
channels head-major, the reference dim-head-major) inverted.  Like the
forward mapping it assumes conv_block=BasicBlock, proj_type=depthwise,
norm='in' and aux_loss on (``Conv_0`` is the aux head, ``Conv_1`` outc).
One difference: a decoder conv block gets a shortcut only where the model
has one (see the decoder loop).

The input is the Flax params tree as nested dicts of numpy arrays; nothing
here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import DEFAULT_CHAN_NUM


def _bmha_perm(heads: int, dim_head: int) -> np.ndarray:
    """Flax channel h*dim_head + d holds reference channel d*heads + h."""
    perm = np.empty(heads * dim_head, np.int64)
    for d in range(dim_head):
        for h in range(heads):
            perm[h * dim_head + d] = d * heads + h
    return perm


def conv_from_flax(w) -> np.ndarray:
    w = np.asarray(w)
    nd = w.ndim
    return np.transpose(w, (nd - 1, nd - 2, *range(nd - 2)))


def medformer3d_state_dict_from_jax(params, cfg) -> dict:
    """Flax MedFormer3D params (nested dicts of arrays) -> state_dict."""
    chan_num = list(cfg.get("chan_num") or DEFAULT_CHAN_NUM)
    conv_num, trans_num = cfg.conv_num, cfg.trans_num
    num_heads = cfg.num_heads
    dim_head = [chan_num[i] // num_heads[i] for i in range(8)]
    sd: dict[str, np.ndarray] = {}

    def node(path):
        n = params
        for part in path:
            n = n[part]
        return n

    def conv(path, key, transform=None):
        w = conv_from_flax(node(path))
        sd[key] = transform(w) if transform is not None else w

    def raw(path, key):
        sd[key] = np.asarray(node(path))

    def basic_block(prefix, tkey, has_shortcut):
        conv((*prefix, "ConvNormAct_0", "Conv_0", "kernel"),
             f"{tkey}.conv1.conv.weight")
        conv((*prefix, "ConvNormAct_1", "Conv_0", "kernel"),
             f"{tkey}.conv2.conv.weight")
        if has_shortcut:
            conv((*prefix, "ConvNormAct_2", "Conv_0", "kernel"),
                 f"{tkey}.shortcut.conv.weight")

    def dwsep(prefix, tkey, out_perm=None, in_perm=None):
        inv_out = None if out_perm is None else np.argsort(out_perm)
        inv_in = None if in_perm is None else np.argsort(in_perm)

        def dw(w):
            return w if inv_in is None else w[inv_in]

        def pw(w):
            if inv_in is not None:
                w = w[:, inv_in]
            return w if inv_out is None else w[inv_out]

        conv((*prefix, "Conv_0", "kernel"), f"{tkey}.depthwise.weight", dw)
        conv((*prefix, "Conv_1", "kernel"), f"{tkey}.pointwise.weight", pw)

    def mbconv(prefix, tkey):
        conv((*prefix, "ConvNormAct_0", "Conv_0", "kernel"),
             f"{tkey}.expand_proj.conv.weight")
        conv((*prefix, "ConvNormAct_1", "Conv_0", "kernel"),
             f"{tkey}.depthwise.conv.weight")
        conv((*prefix, "SEBlock_0", "Conv_0", "kernel"),
             f"{tkey}.se.excitation.0.weight")
        raw((*prefix, "SEBlock_0", "Conv_0", "bias"),
            f"{tkey}.se.excitation.0.bias")
        conv((*prefix, "SEBlock_0", "Conv_1", "kernel"),
             f"{tkey}.se.excitation.2.weight")
        raw((*prefix, "SEBlock_0", "Conv_1", "bias"),
            f"{tkey}.se.excitation.2.bias")
        conv((*prefix, "ConvNormAct_2", "Conv_0", "kernel"),
             f"{tkey}.pointwise.conv.weight")

    def bmha_block(prefix, tkey, heads, dh, has_shortcut, no_map_out=False):
        inner = heads * dh
        perm = _bmha_perm(heads, dh)
        qv_perm = np.concatenate([perm, inner + perm])
        inv_qv = np.argsort(qv_perm)
        inv = np.argsort(perm)
        attn = (*prefix, "BidirectionAttention_0")
        dwsep((*attn, "DepthwiseSeparableConv_0"), f"{tkey}.attn.feat_qv",
              out_perm=qv_perm)
        conv((*attn, "Conv_0", "kernel"), f"{tkey}.attn.map_qv.weight",
             lambda w: w[inv_qv])
        dwsep((*attn, "DepthwiseSeparableConv_1"), f"{tkey}.attn.feat_out",
              in_perm=perm)
        if not no_map_out:
            conv((*attn, "Conv_1", "kernel"), f"{tkey}.attn.map_out.weight",
                 lambda w: w[:, inv])
        if has_shortcut:
            conv((*prefix, "ConvNormAct_0", "Conv_0", "kernel"),
                 f"{tkey}.shortcut.conv.weight")
        mbconv((*prefix, "MBConv_0"), f"{tkey}.feedforward")

    # --- encoder -----------------------------------------------------------
    conv(("inc", "Conv_0", "kernel"), "inc.conv1.weight")
    basic_block(("inc", "BasicBlock_0"), "inc.conv2", False)
    for i in range(4):
        name = f"down{i + 1}"
        dwsep((name, "PatchMerging_0", "DepthwiseSeparableConv_0"),
              f"{name}.patch_merging.reduction")
        for j in range(conv_num[i]):
            basic_block((name, f"BasicBlock_{j}"), f"{name}.conv_blocks.{j}",
                        False)
        if i > 0:
            conv((name, "SemanticMapGeneration_0", "Conv_0", "kernel"),
                 f"{name}.map_gen.base_proj.weight")
            conv((name, "SemanticMapGeneration_0", "Conv_1", "kernel"),
                 f"{name}.map_gen.semantic_proj.weight")
        for j in range(trans_num[i]):
            bmha_block((name, "BasicLayer_0", f"BidirectionAttentionBlock_{j}"),
                       f"{name}.trans_blocks.blocks.{j}", num_heads[i],
                       dim_head[i], has_shortcut=False)

    # --- map fusion ----------------------------------------------------------
    mf = "SemanticMapFusion_0"
    for i in range(3):
        conv((mf, f"Conv_{i}", "kernel"), f"map_fusion.in_proj.{i}.weight")
        conv((mf, f"Conv_{i + 3}", "kernel"), f"map_fusion.out_proj.{i}.weight")
    tb = (mf, "TransformerBlock_0")
    for d in range(cfg.fusion_depth):
        base = f"map_fusion.fusion.layers.{d}"
        for j, ln in enumerate((f"LayerNorm_{2 * d}", f"LayerNorm_{2 * d + 1}")):
            raw((*tb, ln, "scale"), f"{base}.{j}.norm.weight")
            raw((*tb, ln, "bias"), f"{base}.{j}.norm.bias")
        sd[f"{base}.0.fn.to_qkv.weight"] = np.asarray(
            node((*tb, f"Attention_{d}", "Dense_0", "kernel"))).T
        sd[f"{base}.0.fn.to_out.weight"] = np.asarray(
            node((*tb, f"Attention_{d}", "Dense_1", "kernel"))).T
        raw((*tb, f"Attention_{d}", "Dense_1", "bias"), f"{base}.0.fn.to_out.bias")
        for k, fc in enumerate(("fc1", "fc2")):
            sd[f"{base}.1.fn.{fc}.weight"] = np.asarray(
                node((*tb, f"Mlp_{d}", f"Dense_{k}", "kernel"))).T
            raw((*tb, f"Mlp_{d}", f"Dense_{k}", "bias"), f"{base}.1.fn.{fc}.bias")

    # --- decoder -------------------------------------------------------------
    for u in range(4):
        name = f"up{u + 1}"
        stage = 4 + u
        if u < 2:   # map shortcut
            conv((name, "Conv_0", "kernel"), f"{name}.map_reduction.weight")
        for j in range(trans_num[stage]):
            no_mo = u == 1 and j == trans_num[stage] - 1   # up2 last block
            bmha_block((name, "BasicLayer_0", f"BidirectionAttentionBlock_{j}"),
                       f"{name}.trans_blocks.blocks.{j}", num_heads[stage],
                       dim_head[stage], has_shortcut=(j == 0), no_map_out=no_mo)
        for j in range(conv_num[stage]):
            # the first conv block widens the concat only when no B-MHA
            # block came before it (import_medformer3d assumes it always
            # does, and raises KeyError for a stage with both, e.g. the
            # AMOS config's up2)
            basic_block((name, f"BasicBlock_{j}"), f"{name}.conv_blocks.{j}",
                        has_shortcut=(j == 0 and trans_num[stage] == 0))

    # aux + out heads (created in that order -> Conv_0, Conv_1)
    conv(("Conv_0", "kernel"), "aux_out.weight")
    raw(("Conv_0", "bias"), "aux_out.bias")
    conv(("Conv_1", "kernel"), "outc.weight")
    raw(("Conv_1", "bias"), "outc.bias")
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}
