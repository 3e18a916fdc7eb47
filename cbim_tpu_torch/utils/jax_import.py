"""Flax variables of every ported model -> this port's state_dict, and
:func:`state_dict_from_jax`, the dispatch by (dimension, model) that loads
the JAX package's checkpoints (the counterpart of
``cbim_tpu.utils.torch_import.import_for_model``).

The exact inverses of ``cbim_tpu.utils.torch_import.import_medformer3d``,
``import_medformer2d``, ``import_swin_unetr``, ``import_vtunet``,
``import_nnformer3d``, ``import_swinunet``, ``import_unet`` (3D and 2D),
``import_unetpp``, ``import_attention_unet``, ``import_vnet``,
``import_unetr``, ``import_daunet`` and ``import_transunet``: the same
walks over the tree, with each layout transform undone

    conv:           (*k, I, O) -> (O, I, *k)
    linear:         (I, O)     -> (O, I)
    transposed conv (*k, I, O), spatially flipped -> (I, O, *k) unflipped

and each channel permutation inverted: the B-MHA's (``_bmha_perm``: Flax
splits the inner channels head-major, the reference dim-head-major) and,
in 2D, the map fusion's ``to_out`` columns (the dim2 reference merges its
heads dim-head-major).  Both assume aux_loss on (``Conv_0`` is the aux
head, ``Conv_1`` outc), and take the config's ``conv_block``,
``proj_type`` (the B-MHA's and PatchMerging's projections; the
FusedMBConv feed-forward under "linear") and ``expansion``.  Every walk
carries a norm's parameters where the tree has them: a ``bn`` norm's
scale, bias and, from ``batch_stats``, running mean and variance
(``num_batches_tracked`` is 0), an ``ln`` norm's scale and bias; ``in``
has none.  So ``load_state_dict`` takes the result strictly.  A conv block
(``_Walk.block``: SingleConv, BasicBlock, Bottleneck, MBConv, FusedMBConv,
ConvNeXtBlock) gets a shortcut where the Flax tree has one, which is where
the model has one; so, unlike ``import_medformer3d``, a 3D decoder conv
block gets a shortcut only where the model has one.  The 2D zoo's
BatchNorms are carried, which ``import_unet`` itself leaves out (ROADMAP
C15).  ConvNeXtBlock, which no factory builds, maps alone
(:func:`block_state_dict_from_jax`).
TransUNet's fused qkv ``Dense_0`` splits back into the reference's
``query``, ``key`` and ``value``.  :func:`transunet_npz_state_dict` reads
the official R50+ViT-B_16 ``.npz`` (``import_transunet_npz``'s map).

The input is the Flax tree as nested dicts of numpy arrays; nothing here
imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import DEFAULT_CHAN_NUM
from ..models.nnformer import DEPTHS as NNFORMER_DEPTHS
from ..models.swin_unet import DEPTHS as SWINUNET_DEPTHS
from ..models.swin_unetr import DEPTHS as SWIN_DEPTHS
from ..models.vtunet import DEPTHS as VTUNET_DEPTHS


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


def convtranspose_from_flax(w) -> np.ndarray:
    """Inverse of ``convtranspose_to_flax``: undo its spatial flip, then
    (*k, I, O) -> torch's ConvTranspose (I, O, *k)."""
    w = np.asarray(w)
    nd = w.ndim
    w = w[(slice(None, None, -1),) * (nd - 2)]
    return np.ascontiguousarray(np.transpose(w, (nd - 2, nd - 1,
                                                 *range(nd - 2))))


class _Walk:
    """Collects state_dict entries from a Flax params tree (and, for
    BatchNorm, its ``batch_stats`` tree)."""

    def __init__(self, params, batch_stats=None):
        self.params = params
        self.batch_stats = batch_stats or {}
        self.sd: dict[str, np.ndarray] = {}

    @staticmethod
    def _get(tree, path):
        for part in path:
            tree = tree[part]
        return tree

    def has(self, path) -> bool:
        try:
            self._get(self.params, path)
        except KeyError:
            return False
        return True

    def conv(self, path, key, transform=None):
        w = conv_from_flax(self._get(self.params, path))
        self.sd[key] = transform(w) if transform is not None else w

    def raw(self, path, key):
        self.sd[key] = np.asarray(self._get(self.params, path))

    def conv_transpose(self, path, key):
        self.sd[key] = convtranspose_from_flax(self._get(self.params, path))

    def linear(self, path, key, transform=None):
        w = np.asarray(self._get(self.params, path)).T
        self.sd[key] = transform(w) if transform is not None else w

    def bn(self, path, tkey):
        """``path``/BatchNorm_0 -> ``tkey``.{weight, bias, running_*}."""
        self.batch_norm((*path, "BatchNorm_0"), tkey)

    def batch_norm(self, bn, tkey):
        """The BatchNorm at ``bn`` -> ``tkey``.{weight, bias, running_*}."""
        self.raw((*bn, "scale"), f"{tkey}.weight")
        self.raw((*bn, "bias"), f"{tkey}.bias")
        stats = self._get(self.batch_stats, bn)
        self.sd[f"{tkey}.running_mean"] = np.asarray(stats["mean"])
        self.sd[f"{tkey}.running_var"] = np.asarray(stats["var"])
        self.sd[f"{tkey}.num_batches_tracked"] = np.zeros((), np.int64)

    def norm(self, path, tkey):
        """A ``Norm`` at ``path`` with parameters: its BatchNorm_0 (with
        statistics) or LayerNorm_0 -> ``tkey``.{weight, bias, ...}."""
        if self.has((*path, "LayerNorm_0")):
            self.layer_norm((*path, "LayerNorm_0"), tkey)
        else:
            self.bn(path, tkey)

    def cna(self, path, tkey):
        """One ConvNormAct: Conv_0 and, where it has parameters (bn, ln),
        Norm_0."""
        self.conv((*path, "Conv_0", "kernel"), f"{tkey}.conv.weight")
        if self.has((*path, "Norm_0")):
            self.norm((*path, "Norm_0"), f"{tkey}.norm")

    def se(self, path, tkey):
        """SEBlock_0 at ``path`` -> ``tkey``.excitation.{0, 2}."""
        for i, j in ((0, 0), (1, 2)):
            self.conv((*path, f"Conv_{i}", "kernel"),
                      f"{tkey}.excitation.{j}.weight")
            self.raw((*path, f"Conv_{i}", "bias"),
                     f"{tkey}.excitation.{j}.bias")

    def convs(self, prefix, tkey, names):
        """ConvNormAct_0, _1, ... of a block -> ``tkey``.{names}, and the
        next one, where the tree has it, -> ``tkey``.shortcut."""
        for i, name in enumerate((*names, "shortcut")):
            path = (*prefix, f"ConvNormAct_{i}")
            if name != "shortcut" or self.has(path):
                self.cna(path, f"{tkey}.{name}")

    def block(self, prefix, tkey, kind, se_name="se", expansion=4):
        """One conv block of ``kind`` (the Flax class name: SingleConv,
        BasicBlock, Bottleneck, MBConv, FusedMBConv or ConvNeXtBlock) ->
        the port's names (``layers/convs.py``), a shortcut where the tree
        has one; ``se_name`` and ``expansion`` as the module was built."""
        if kind == "SingleConv":
            self.cna((*prefix, "ConvNormAct_0"), f"{tkey}.conv")
        elif kind == "BasicBlock":
            self.convs(prefix, tkey, ("conv1", "conv2"))
        elif kind == "Bottleneck":
            self.convs(prefix, tkey, ("conv1", "conv2", "conv3"))
        elif kind == "MBConv":
            self.mbconv(prefix, tkey, se_name, expansion)
        elif kind == "FusedMBConv":
            self.convs(prefix, tkey, ("conv3x3", "pointwise"))
            self.se((*prefix, "SEBlock_0"), f"{tkey}.{se_name}")
        elif kind == "ConvNeXtBlock":
            self.conv((*prefix, "Conv_0", "kernel"), f"{tkey}.dwconv.weight")
            self.raw((*prefix, "Conv_0", "bias"), f"{tkey}.dwconv.bias")
            self.layer_norm((*prefix, "LayerNorm_0"), f"{tkey}.norm")
            self.dense((*prefix, "Dense_0"), f"{tkey}.pwconv1")
            self.dense((*prefix, "Dense_1"), f"{tkey}.pwconv2")
            if self.has((*prefix, "layer_scale")):
                self.raw((*prefix, "layer_scale"), f"{tkey}.gamma")
        else:
            raise ValueError(f"unknown block {kind!r}")

    def dwsep(self, prefix, tkey, out_perm=None, in_perm=None):
        inv_out = None if out_perm is None else np.argsort(out_perm)
        inv_in = None if in_perm is None else np.argsort(in_perm)

        def dw(w):
            return w if inv_in is None else w[inv_in]

        def pw(w):
            if inv_in is not None:
                w = w[:, inv_in]
            return w if inv_out is None else w[inv_out]

        self.conv((*prefix, "Conv_0", "kernel"), f"{tkey}.depthwise.weight",
                  dw)
        self.conv((*prefix, "Conv_1", "kernel"), f"{tkey}.pointwise.weight",
                  pw)

    def mbconv(self, prefix, tkey, se_name, expansion=4):
        names = ("depthwise", "pointwise")
        if expansion != 1:
            names = ("expand_proj", *names)
        self.convs(prefix, tkey, names)
        self.se((*prefix, "SEBlock_0"), f"{tkey}.{se_name}")

    def bmha_block(self, prefix, tkey, heads, dh, has_shortcut,
                   no_map_out=False, se_name="se", proj_type="depthwise",
                   expansion=4):
        """A BidirectionAttentionBlock: its norms where they have
        parameters, the B-MHA's projections (depthwise-separable, or 1^d
        convs under ``proj_type`` "linear": Flax's Conv_0-Conv_3 in the
        order feat_qv, map_qv, feat_out, map_out), the shortcut, and the
        feed-forward (MBConv_0, or under "linear" FusedMBConv_0)."""
        inner = heads * dh
        perm = _bmha_perm(heads, dh)
        qv_perm = np.concatenate([perm, inner + perm])
        inv_qv = np.argsort(qv_perm)
        inv = np.argsort(perm)
        if self.has((*prefix, "Norm_0")):
            self.norm((*prefix, "Norm_0"), f"{tkey}.norm1")
            self.norm((*prefix, "Norm_1"), f"{tkey}.norm2")
        attn = (*prefix, "BidirectionAttention_0")
        if proj_type == "linear":
            self.conv((*attn, "Conv_0", "kernel"),
                      f"{tkey}.attn.feat_qv.weight", lambda w: w[inv_qv])
            self.conv((*attn, "Conv_2", "kernel"),
                      f"{tkey}.attn.feat_out.weight", lambda w: w[:, inv])
            map_qv, map_out = "Conv_1", "Conv_3"
        else:
            self.dwsep((*attn, "DepthwiseSeparableConv_0"),
                       f"{tkey}.attn.feat_qv", out_perm=qv_perm)
            self.dwsep((*attn, "DepthwiseSeparableConv_1"),
                       f"{tkey}.attn.feat_out", in_perm=perm)
            map_qv, map_out = "Conv_0", "Conv_1"
        self.conv((*attn, map_qv, "kernel"), f"{tkey}.attn.map_qv.weight",
                  lambda w: w[inv_qv])
        if not no_map_out:
            self.conv((*attn, map_out, "kernel"),
                      f"{tkey}.attn.map_out.weight", lambda w: w[:, inv])
        if has_shortcut:
            self.cna((*prefix, "ConvNormAct_0"), f"{tkey}.shortcut")
        if proj_type == "linear":
            self.block((*prefix, "FusedMBConv_0"), f"{tkey}.feedforward",
                       "FusedMBConv", se_name)
        else:
            self.mbconv((*prefix, "MBConv_0"), f"{tkey}.feedforward",
                        se_name, expansion)

    def patch_merging_mf(self, path, tkey, proj_type):
        """MedFormer's PatchMerging: its norm where it has parameters, and
        the reduction (depthwise-separable, or a 1^d conv)."""
        if self.has((*path, "Norm_0")):
            self.norm((*path, "Norm_0"), f"{tkey}.norm")
        if proj_type == "linear":
            self.conv((*path, "Conv_0", "kernel"), f"{tkey}.reduction.weight")
        else:
            self.dwsep((*path, "DepthwiseSeparableConv_0"),
                       f"{tkey}.reduction")

    def map_fusion(self, depth, out_perm=None):
        """SemanticMapFusion_0 -> map_fusion.*; ``out_perm`` permutes the
        columns of each ``to_out`` (the dim2 head merge)."""
        mf = "SemanticMapFusion_0"
        for i in range(3):
            self.conv((mf, f"Conv_{i}", "kernel"),
                      f"map_fusion.in_proj.{i}.weight")
            self.conv((mf, f"Conv_{i + 3}", "kernel"),
                      f"map_fusion.out_proj.{i}.weight")
        tb = (mf, "TransformerBlock_0")
        inv_out = None if out_perm is None else np.argsort(out_perm)
        for d in range(depth):
            base = f"map_fusion.fusion.layers.{d}"
            for j, ln in enumerate((f"LayerNorm_{2 * d}",
                                    f"LayerNorm_{2 * d + 1}")):
                self.raw((*tb, ln, "scale"), f"{base}.{j}.norm.weight")
                self.raw((*tb, ln, "bias"), f"{base}.{j}.norm.bias")
            att = (*tb, f"Attention_{d}")
            self.linear((*att, "Dense_0", "kernel"), f"{base}.0.fn.to_qkv.weight")
            self.linear((*att, "Dense_1", "kernel"), f"{base}.0.fn.to_out.weight",
                        None if inv_out is None else (lambda w: w[:, inv_out]))
            self.raw((*att, "Dense_1", "bias"), f"{base}.0.fn.to_out.bias")
            for k, fc in enumerate(("fc1", "fc2")):
                mlp = (*tb, f"Mlp_{d}", f"Dense_{k}")
                self.linear((*mlp, "kernel"), f"{base}.1.fn.{fc}.weight")
                self.raw((*mlp, "bias"), f"{base}.1.fn.{fc}.bias")

    def layer_norm(self, path, tkey):
        self.raw((*path, "scale"), f"{tkey}.weight")
        self.raw((*path, "bias"), f"{tkey}.bias")

    def dense(self, path, tkey, bias=True):
        self.linear((*path, "kernel"), f"{tkey}.weight")
        if bias:
            self.raw((*path, "bias"), f"{tkey}.bias")

    def swin_block(self, path, tkey, attn_name="WindowAttention_0",
                   qkv="qkv", mlp=("linear1", "linear2")):
        """A SwinBlock (or nnFormer's block: ``attn_name``
        _WindowAttentionNF_0, ``qkv`` "kv" in kv mode): LayerNorm_0, the
        attention, LayerNorm_1 and the MLP's Dense_0/Dense_1 ->
        ``tkey``.{norm1, attn.*, norm2, mlp.*}, the MLP's two linears named
        ``mlp`` (MONAI's, or the official Swin's fc1/fc2)."""
        attn = (*path, attn_name)
        self.layer_norm((*path, "LayerNorm_0"), f"{tkey}.norm1")
        self.dense((*attn, "Dense_0"), f"{tkey}.attn.{qkv}")
        self.raw((*attn, "relative_position_bias_table"),
                 f"{tkey}.attn.relative_position_bias_table")
        self.dense((*attn, "Dense_1"), f"{tkey}.attn.proj")
        self.layer_norm((*path, "LayerNorm_1"), f"{tkey}.norm2")
        self.dense((*path, "Dense_0"), f"{tkey}.mlp.{mlp[0]}")
        self.dense((*path, "Dense_1"), f"{tkey}.mlp.{mlp[1]}")

    def swin_block_vt(self, path, tkey):
        """A VT-UNet SwinBlockVT: norm1, WindowAttentionVT_0 (Dense_0 the
        qkv, Dense_1 the proj), norm2, mlp_fc1, mlp_fc2 -> ``tkey``.{norm1,
        attn.*, norm2, mlp.fc1, mlp.fc2}."""
        attn = (*path, "WindowAttentionVT_0")
        self.layer_norm((*path, "norm1"), f"{tkey}.norm1")
        self.dense((*attn, "Dense_0"), f"{tkey}.attn.qkv")
        self.raw((*attn, "relative_position_bias_table"),
                 f"{tkey}.attn.relative_position_bias_table")
        self.dense((*attn, "Dense_1"), f"{tkey}.attn.proj")
        self.layer_norm((*path, "norm2"), f"{tkey}.norm2")
        self.dense((*path, "mlp_fc1"), f"{tkey}.mlp.fc1")
        self.dense((*path, "mlp_fc2"), f"{tkey}.mlp.fc2")

    def patch_merging(self, path, tkey):
        self.layer_norm((*path, "LayerNorm_0"), f"{tkey}.norm")
        self.dense((*path, "Dense_0"), f"{tkey}.reduction", bias=False)

    def unet_res_block(self, path, tkey):
        """unetr.UnetResBlock -> MONAI's conv{1,2,3}/norm{1,2,3} (the third
        pair where the block has a projected residual)."""
        for i in range(3 if self.has((*path, "Conv_2")) else 2):
            self.conv((*path, f"Conv_{i}", "kernel"),
                      f"{tkey}.conv{i + 1}.weight")
            self.layer_norm((*path, f"_INorm_{i}"), f"{tkey}.norm{i + 1}")

    def heads(self):
        """aux + out heads (created in that order -> Conv_0, Conv_1)."""
        self.conv(("Conv_0", "kernel"), "aux_out.weight")
        self.raw(("Conv_0", "bias"), "aux_out.bias")
        self.conv(("Conv_1", "kernel"), "outc.weight")
        self.raw(("Conv_1", "bias"), "outc.bias")

    def state_dict(self) -> dict:
        return {k: torch.tensor(v) if v.dtype == np.int64
                else torch.tensor(v, dtype=torch.float32)
                for k, v in self.sd.items()}


def _mf_options(cfg):
    """A MedFormer config's conv block (as the Flax tree names it), its
    feed-forward expansion and its projection type."""
    return (_block_kind(cfg.get("conv_block") or "BasicBlock"),
            cfg.get("expansion") or 4, cfg.get("proj_type") or "depthwise")


def medformer3d_state_dict_from_jax(params, cfg, batch_stats=None) -> dict:
    """Flax MedFormer3D params (nested dicts of arrays; ``batch_stats``
    where its norm is bn) -> state_dict."""
    chan_num = list(cfg.get("chan_num") or DEFAULT_CHAN_NUM)
    conv_num, trans_num = cfg.conv_num, cfg.trans_num
    num_heads = cfg.num_heads
    dim_head = [chan_num[i] // num_heads[i] for i in range(8)]
    kind, expansion, proj_type = _mf_options(cfg)
    t = _Walk(params, batch_stats)

    def bmha(name, stage, j, **kw):
        t.bmha_block((name, "BasicLayer_0", f"BidirectionAttentionBlock_{j}"),
                     f"{name}.trans_blocks.blocks.{j}", num_heads[stage],
                     dim_head[stage], proj_type=proj_type,
                     expansion=expansion, **kw)

    # --- encoder -----------------------------------------------------------
    t.conv(("inc", "Conv_0", "kernel"), "inc.conv1.weight")
    t.block(("inc", f"{kind}_0"), "inc.conv2", kind)
    for i in range(4):
        name = f"down{i + 1}"
        t.patch_merging_mf((name, "PatchMerging_0"),
                           f"{name}.patch_merging", proj_type)
        for j in range(conv_num[i]):
            t.block((name, f"{kind}_{j}"), f"{name}.conv_blocks.{j}", kind)
        if i > 0:
            t.conv((name, "SemanticMapGeneration_0", "Conv_0", "kernel"),
                   f"{name}.map_gen.base_proj.weight")
            t.conv((name, "SemanticMapGeneration_0", "Conv_1", "kernel"),
                   f"{name}.map_gen.semantic_proj.weight")
        for j in range(trans_num[i]):
            bmha(name, i, j, has_shortcut=False)

    t.map_fusion(cfg.fusion_depth)

    # --- decoder -------------------------------------------------------------
    for u in range(4):
        name = f"up{u + 1}"
        stage = 4 + u
        if u < 2:   # map shortcut
            t.conv((name, "Conv_0", "kernel"), f"{name}.map_reduction.weight")
        for j in range(trans_num[stage]):
            no_mo = u == 1 and j == trans_num[stage] - 1   # up2 last block
            bmha(name, stage, j, has_shortcut=(j == 0), no_map_out=no_mo)
        for j in range(conv_num[stage]):
            # the first conv block widens the concat only when no B-MHA
            # block came before it: the walk takes a shortcut where the
            # tree has one (import_medformer3d assumes one always, and
            # raises KeyError for a stage with both, e.g. the AMOS config's
            # up2)
            t.block((name, f"{kind}_{j}"), f"{name}.conv_blocks.{j}", kind)
    t.heads()
    return t.state_dict()


def medformer2d_state_dict_from_jax(variables, cfg) -> dict:
    """Flax MedFormer2D variables {"params", "batch_stats"} (nested dicts of
    arrays) -> state_dict with every BatchNorm's running statistics."""
    b = cfg.base_chan
    chan_num = [2 * b, 4 * b, 8 * b, 16 * b, 8 * b, 4 * b, 2 * b, b]
    conv_num, trans_num = cfg.conv_num, cfg.trans_num
    num_heads = cfg.num_heads
    dim_head = [chan_num[i] // num_heads[i] for i in range(8)]
    kind, expansion, proj_type = _mf_options(cfg)
    t = _Walk(variables["params"], variables["batch_stats"])

    def blocks(prefix, tkey, n):
        for j in range(n):
            t.block((*prefix, f"{kind}_{j}"), f"{tkey}.conv_blocks.{j}", kind,
                    se_name="se_block")

    def bmha(prefix, tkey, stage):
        for j in range(trans_num[stage]):
            t.bmha_block((*prefix, "BasicLayer_0",
                          f"BidirectionAttentionBlock_{j}"),
                         f"{tkey}.trans_blocks.blocks.{j}", num_heads[stage],
                         dim_head[stage], has_shortcut=False,
                         se_name="se_block", proj_type=proj_type,
                         expansion=expansion)

    # --- encoder -----------------------------------------------------------
    t.conv(("InConvMF_0", "Conv_0", "kernel"), "inc.conv1.weight")
    t.block(("InConvMF_0", f"{kind}_0"), "inc.conv2", kind,
            se_name="se_block")
    for i in range(4):
        f, name = f"DownBlockMF_{i}", f"down{i + 1}"
        t.patch_merging_mf((f, "PatchMerging_0"), f"{name}.patch_merging",
                           proj_type)
        blocks((f,), name, conv_num[i])
        if i > 0:
            t.conv((f, "SemanticMapGeneration_0", "Conv_0", "kernel"),
                   f"{name}.map_gen.base_proj.weight")
            t.conv((f, "SemanticMapGeneration_0", "Conv_1", "kernel"),
                   f"{name}.map_gen.semantic_proj.weight")
        bmha((f,), name, i)

    # dim2 attention merges its heads dim-head-major on the way out
    t.map_fusion(cfg.fusion_depth, out_perm=_bmha_perm(
        cfg.fusion_heads, cfg.fusion_dim // cfg.fusion_heads))

    # --- decoder -------------------------------------------------------------
    for u in range(4):
        f, name = f"UpBlockMF2D_{u}", f"up{u + 1}"
        t.norm((f, "Norm_0"), f"{name}.norm")
        t.conv((f, "Conv_0", "kernel"), f"{name}.reduction.weight")
        t.conv((f, "Conv_1", "kernel"), f"{name}.map_reduction.weight")
        bmha((f,), name, 4 + u)
        blocks((f,), name, conv_num[4 + u])
    t.heads()
    return t.state_dict()


def swin_unetr_state_dict_from_jax(params) -> dict:
    """Flax SwinUNETR params (nested dicts of arrays) -> state_dict, with the
    reference's names (the keys ``import_swin_unetr`` reads)."""
    t = _Walk(params)
    sw = ("SwinTransformer3D_0",)
    t.conv((*sw, "Conv_0", "kernel"), "swinViT.patch_embed.proj.weight")
    t.raw((*sw, "Conv_0", "bias"), "swinViT.patch_embed.proj.bias")
    blk = 0
    for stage, depth in enumerate(SWIN_DEPTHS):
        tkey = f"swinViT.layers{stage + 1}.0"
        for b in range(depth):
            t.swin_block((*sw, f"SwinBlock_{blk}"), f"{tkey}.blocks.{b}")
            blk += 1
        t.patch_merging((*sw, f"PatchMergingLegacy_{stage}"),
                        f"{tkey}.downsample")
    for i, name in enumerate(("encoder1", "encoder2", "encoder3", "encoder4",
                              "encoder10")):
        t.unet_res_block((f"UnetResBlock_{i}",), f"{name}.layer")
    for i, name in enumerate(("decoder5", "decoder4", "decoder3", "decoder2",
                              "decoder1")):
        t.conv_transpose((f"_TranspConv_{i}", "ConvTranspose_0", "kernel"),
                         f"{name}.transp_conv.weight")
        t.unet_res_block((f"UnetResBlock_{i + 5}",), f"{name}.conv_block")
    t.conv(("Conv_0", "kernel"), "out.conv.weight")
    t.raw(("Conv_0", "bias"), "out.conv.bias")
    return t.state_dict()


def vtunet_state_dict_from_jax(params, depths=VTUNET_DEPTHS) -> dict:
    """Flax VTUNet params (nested dicts of arrays) -> state_dict, with the
    reference's names (the keys ``import_vtunet`` reads).  Flax numbers the
    blocks encoder first, then decoder stage by stage; the decoder's stage
    ``inx`` (1..) decodes encoder stage ``len(depths) - 1 - inx``."""
    t = _Walk(params)
    pre = "swin_unet"
    t.conv(("Conv_0", "kernel"), f"{pre}.patch_embed.proj.weight")
    t.raw(("Conv_0", "bias"), f"{pre}.patch_embed.proj.bias")
    t.layer_norm(("LayerNorm_0",), f"{pre}.patch_embed.norm")

    bi = 0
    for i, depth in enumerate(depths):
        for b in range(depth):
            t.swin_block_vt((f"SwinBlockVT_{bi}",),
                            f"{pre}.layers.{i}.blocks.{b}")
            bi += 1
        if i < len(depths) - 1:
            pm = (f"PatchMergingHW_{i}",)
            down = f"{pre}.layers.{i}.downsample"
            t.layer_norm((*pm, "LayerNorm_0"), f"{down}.norm")
            t.dense((*pm, "Dense_0"), f"{down}.reduction", bias=False)
    t.layer_norm(("LayerNorm_1",), f"{pre}.norm")
    t.dense(("PatchExpandHW_0", "Dense_0"), f"{pre}.layers_up.0.expand",
            bias=False)
    t.layer_norm(("PatchExpandHW_0", "LayerNorm_0"), f"{pre}.layers_up.0.norm")
    for inx in range(1, len(depths)):
        t.dense((f"Dense_{inx - 1}",), f"{pre}.concat_back_dim.{inx}",
                bias=False)
        for b in range(depths[len(depths) - 1 - inx]):
            t.swin_block_vt((f"SwinBlockVT_{bi}",),
                            f"{pre}.layers_up.{inx}.blocks.{b}")
            bi += 1
        if inx < len(depths) - 1:
            pe = (f"PatchExpandHW_{inx}",)
            up = f"{pre}.layers_up.{inx}.upsample"
            t.dense((*pe, "Dense_0"), f"{up}.expand", bias=False)
            t.layer_norm((*pe, "LayerNorm_0"), f"{up}.norm")
    t.layer_norm(("LayerNorm_2",), f"{pre}.norm_up")
    t.dense(("FinalPatchExpand_0", "Dense_0"), f"{pre}.up.expand", bias=False)
    t.layer_norm(("FinalPatchExpand_0", "LayerNorm_0"), f"{pre}.up.norm")
    t.conv(("Conv_1", "kernel"), f"{pre}.output.weight")
    return t.state_dict()


def nnformer_state_dict_from_jax(params, depths=NNFORMER_DEPTHS) -> dict:
    """Flax NNFormer params (nested dicts of arrays, deep supervision on)
    -> state_dict, with the reference's names (the keys
    ``import_nnformer3d`` reads).  Flax numbers the blocks encoder first,
    then decoder stage by stage, coarsest first; the reference builds
    ``decoder.layers`` reversed, so decoder stage j is ``decoder.layers.{nu
    - 1 - j}``, and the heads, created coarsest first, are ``final.{nu - 1
    - k}``."""
    t = _Walk(params)
    pe = "model_down.patch_embed"
    for pi in (0, 1):
        proj, tkey = (f"_Project_{pi}",), f"{pe}.proj{pi + 1}"
        for ci in (0, 1):
            t.conv((*proj, f"Conv_{ci}", "kernel"),
                   f"{tkey}.conv{ci + 1}.weight")
            t.raw((*proj, f"Conv_{ci}", "bias"), f"{tkey}.conv{ci + 1}.bias")
        t.layer_norm((*proj, "LayerNorm_0"), f"{tkey}.norm1")
        if t.has((*proj, "LayerNorm_1")):
            t.layer_norm((*proj, "LayerNorm_1"), f"{tkey}.norm2")
    t.layer_norm(("LayerNorm_0",), f"{pe}.norm")

    nf = "_WindowAttentionNF_0"
    fc = ("fc1", "fc2")
    bi = 0
    for i, depth in enumerate(depths):
        for b in range(depth):
            t.swin_block((f"_NFBlock_{bi}",),
                         f"model_down.layers.{i}.blocks.{b}", nf, mlp=fc)
            bi += 1
        t.layer_norm((f"LayerNorm_{1 + i}",), f"model_down.norm{i}")
        if i < len(depths) - 1:
            pm, down = (f"_PatchMergingNF_{i}",), \
                f"model_down.layers.{i}.downsample"
            t.layer_norm((*pm, "LayerNorm_0"), f"{down}.norm")
            t.conv((*pm, "Conv_0", "kernel"), f"{down}.reduction.weight")
            t.raw((*pm, "Conv_0", "bias"), f"{down}.reduction.bias")

    dec_depths = list(depths[::-1][1:])
    nu = len(dec_depths)
    for j, depth in enumerate(dec_depths):
        tl, up = f"decoder.layers.{nu - 1 - j}", (f"_PatchExpandingNF_{j}",)
        t.layer_norm((*up, "LayerNorm_0"), f"{tl}.Upsample.norm")
        t.conv_transpose((*up, "ConvTranspose_0", "kernel"),
                         f"{tl}.Upsample.up.weight")
        t.raw((*up, "ConvTranspose_0", "bias"), f"{tl}.Upsample.up.bias")
        for b in range(depth):
            t.swin_block((f"_NFBlock_{bi}",), f"{tl}.blocks.{b}", nf,
                         qkv="kv" if b == 0 else "qkv", mlp=fc)
            bi += 1
    for k in range(nu):
        t.conv_transpose((f"ConvTranspose_{k}", "kernel"),
                         f"final.{nu - 1 - k}.up.weight")
        t.raw((f"ConvTranspose_{k}", "bias"), f"final.{nu - 1 - k}.up.bias")
    return t.state_dict()


def swinunet_state_dict_from_jax(params, depths=SWINUNET_DEPTHS) -> dict:
    """Flax SwinUnet2D params (nested dicts of arrays) -> state_dict, with
    the reference's names (the keys ``import_swinunet`` reads).  Flax
    numbers the blocks encoder first, then decoder stage by stage; the
    decoder's stage ``inx`` (1..) runs encoder stage ``len(depths) - 1 -
    inx``'s depth."""
    t = _Walk(params)
    pre = "swin_unet"
    fc = ("fc1", "fc2")
    t.conv(("Conv_0", "kernel"), f"{pre}.patch_embed.proj.weight")
    t.raw(("Conv_0", "bias"), f"{pre}.patch_embed.proj.bias")
    t.layer_norm(("LayerNorm_0",), f"{pre}.patch_embed.norm")
    bi = 0
    for i, depth in enumerate(depths):
        for b in range(depth):
            t.swin_block((f"SwinBlock_{bi}",),
                         f"{pre}.layers.{i}.blocks.{b}", mlp=fc)
            bi += 1
        if i < len(depths) - 1:
            t.patch_merging((f"PatchMergingLegacy_{i}",),
                            f"{pre}.layers.{i}.downsample")
    t.layer_norm(("LayerNorm_1",), f"{pre}.norm")
    t.dense(("PatchExpand2D_0", "Dense_0"), f"{pre}.layers_up.0.expand",
            bias=False)
    t.layer_norm(("PatchExpand2D_0", "LayerNorm_0"), f"{pre}.layers_up.0.norm")
    for inx in range(1, len(depths)):
        t.dense((f"Dense_{inx - 1}",), f"{pre}.concat_back_dim.{inx}")
        for b in range(depths[len(depths) - 1 - inx]):
            t.swin_block((f"SwinBlock_{bi}",),
                         f"{pre}.layers_up.{inx}.blocks.{b}", mlp=fc)
            bi += 1
        if inx < len(depths) - 1:
            pe = (f"PatchExpand2D_{inx}",)
            up = f"{pre}.layers_up.{inx}.upsample"
            t.dense((*pe, "Dense_0"), f"{up}.expand", bias=False)
            t.layer_norm((*pe, "LayerNorm_0"), f"{up}.norm")
    t.layer_norm(("LayerNorm_2",), f"{pre}.norm_up")
    t.dense(("FinalPatchExpandX4_0", "Dense_0"), f"{pre}.up.expand",
            bias=False)
    t.layer_norm(("FinalPatchExpandX4_0", "LayerNorm_0"), f"{pre}.up.norm")
    t.conv(("Conv_1", "kernel"), f"{pre}.output.weight")
    return t.state_dict()


def _blocks(t, prefix, tkey, block, nd):
    """One conv block of the UNet family (``block`` as :func:`_block_kind`
    gives it; a 2D MBConv names its SE ``se_block``)."""
    t.block(prefix, tkey, block, se_name="se_block" if nd == 2 else "se")


#: the blocks of the JAX package's table by config string, as the Flax tree
#: names their modules (the alias ConvNormAct is SingleConv)
BLOCK_KINDS = {"SingleConv": "SingleConv", "ConvNormAct": "SingleConv",
               "BasicBlock": "BasicBlock", "Bottleneck": "Bottleneck",
               "MBConv": "MBConv", "FusedMBConv": "FusedMBConv"}


def _block_kind(block) -> str:
    """A config's block as the Flax tree names it (None: the JAX config's
    default ConvNormAct, SingleConv).  ConvNeXtBlock raises: no JAX
    factory can build a model with it (its blocks take no norm or act), so
    no Flax tree of one exists; ``block_state_dict_from_jax`` maps the
    block alone."""
    block = block or "ConvNormAct"
    if block == "ConvNeXtBlock":
        raise NotImplementedError(
            "ConvNeXtBlock: the model factories cannot build it (it takes "
            "no norm or act), so no Flax model tree holds one")
    if block not in BLOCK_KINDS:
        raise ValueError(f"unknown block {block!r}")
    return BLOCK_KINDS[block]


def block_state_dict_from_jax(variables, block: str, nd: int = 3,
                              expansion: int = 4) -> dict:
    """The state_dict of one block module (``layers/convs.py``: any of the
    JAX table, ConvNeXtBlock included) from the Flax variables of the same
    block applied alone ({"params"}, and "batch_stats" for bn)."""
    t = _Walk(variables["params"], variables.get("batch_stats"))
    kind = "ConvNeXtBlock" if block == "ConvNeXtBlock" else _block_kind(block)
    t.block((), "", kind, se_name="se_block" if nd == 2 else "se",
            expansion=expansion)
    return {k.lstrip("."): v for k, v in t.state_dict().items()}


def _unet_encoder(t, block, nd):
    """InConv_0 and the four DownBlocks (``import_unet``'s walk)."""
    t.conv(("InConv_0", "Conv_0", "kernel"), "inc.conv1.weight")
    _blocks(t, ("InConv_0", f"{block}_0"), "inc.conv2", block, nd)
    for i in range(4):
        for j in range(2):
            _blocks(t, (f"DownBlock_{i}", f"{block}_{j}"),
                    f"down{i + 1}.conv.{j + 1}", block, nd)


def _unet_decoder(t, block, up_name, nd):
    """The four up blocks ``{up_name}_{i}``: a 2D one's ``conv_ch``
    (Conv_0, with bias) where the tree has it, then its blocks; and
    ``outc``."""
    for i in range(4):
        up = f"{up_name}_{i}"
        if t.has((up, "Conv_0")):
            t.conv((up, "Conv_0", "kernel"), f"up{i + 1}.conv_ch.weight")
            t.raw((up, "Conv_0", "bias"), f"up{i + 1}.conv_ch.bias")
        for j in range(2):
            _blocks(t, (up, f"{block}_{j}"), f"up{i + 1}.conv.{j}", block,
                    nd)
    t.conv(("Conv_0", "kernel"), "outc.weight")
    t.raw(("Conv_0", "bias"), "outc.bias")


def unet3d_state_dict_from_jax(variables, cfg) -> dict:
    """Flax UNet3D variables (UNet or ResUNet by ``cfg.block``) ->
    state_dict (the keys ``import_unet`` reads)."""
    t = _Walk(variables["params"], variables.get("batch_stats"))
    block = _block_kind(cfg.get("block"))
    _unet_encoder(t, block, 3)
    _unet_decoder(t, block, "UpBlock3D", 3)
    return t.state_dict()


def unet2d_state_dict_from_jax(variables, cfg) -> dict:
    """Flax UNet2D variables (UNet or ResUNet by ``cfg.block``) ->
    state_dict: ``import_unet(dimension="2d")``'s keys, each up block's
    ``conv_ch``, and every BatchNorm's scale, bias and statistics (which
    that importer leaves out, ROADMAP C15)."""
    t = _Walk(variables["params"], variables.get("batch_stats"))
    block = _block_kind(cfg.get("block"))
    _unet_encoder(t, block, 2)
    _unet_decoder(t, block, "UpBlock2D", 2)
    return t.state_dict()


def _attention_unet(variables, block, nd) -> dict:
    t = _Walk(variables["params"], variables.get("batch_stats"))
    _unet_encoder(t, block, nd)
    for i in range(4):
        for c, name in enumerate(("W_g", "W_x", "psi")):
            t.conv((f"AttentionUpBlock_{i}", "AttentionGate_0", f"Conv_{c}",
                    "kernel"), f"up{i + 1}.attn.{name}.0.weight")
    _unet_decoder(t, block, "AttentionUpBlock", nd)
    return t.state_dict()


def attention_unet3d_state_dict_from_jax(variables, cfg) -> dict:
    """Flax AttentionUNet3D variables -> state_dict (the keys
    ``import_attention_unet`` reads; no ``conv_ch``)."""
    return _attention_unet(variables, _block_kind(cfg.get("block")), 3)


def attention_unet2d_state_dict_from_jax(variables, cfg=None) -> dict:
    """Flax AttentionUNet2D variables -> state_dict (the keys
    ``import_attention_unet(dimension="2d")`` reads; no ``conv_ch``).  The
    JAX factory builds it with SingleConv blocks whatever the config."""
    return _attention_unet(variables, "SingleConv", 2)


#: UNet++'s stages in the Flax tree's order (``_Stage_{i}``), by their
#: reference names
UNETPP_ORDER = ("conv0_0", "conv1_0", "conv0_1", "conv2_0", "conv1_1",
                "conv0_2", "conv3_0", "conv2_1", "conv1_2", "conv0_3",
                "conv4_0", "conv3_1", "conv2_2", "conv1_3", "conv0_4")


def _unetpp(variables, block, nd) -> dict:
    t = _Walk(variables["params"], variables.get("batch_stats"))
    for si, name in enumerate(UNETPP_ORDER):
        for j in range(2):
            _blocks(t, (f"_Stage_{si}", f"{block}_{j}"), f"{name}.{j}",
                    block, nd)
    t.conv(("Conv_0", "kernel"), "output.weight")
    t.raw(("Conv_0", "bias"), "output.bias")
    return t.state_dict()


def unetpp3d_state_dict_from_jax(variables, cfg) -> dict:
    """Flax UNetPlusPlus3D variables -> state_dict (the keys
    ``import_unetpp`` reads)."""
    return _unetpp(variables, _block_kind(cfg.get("block")), 3)


def unetpp2d_state_dict_from_jax(variables, cfg=None) -> dict:
    """Flax UNetPlusPlus2D variables -> state_dict (the keys
    ``import_unetpp`` reads, BatchNorm included).  The JAX factory builds
    it with SingleConv blocks whatever the config."""
    return _unetpp(variables, "SingleConv", 2)


#: DAUNet's head in the Flax tree's order: (BatchNorm, conv) pairs
#: ``Norm_{i}``/``Conv_{i}``, then the three 1x1 heads Conv_4-Conv_6
DAHEAD_PAIRS = ("conv_a", "conv_a_1", "conv_c", "conv_c_1")
DAHEAD_HEADS = ("fuse_out", "conv_a_out", "conv_c_out")


def daunet_state_dict_from_jax(variables, cfg) -> dict:
    """Flax DAUNet2D variables -> state_dict (the keys ``import_daunet``
    reads): the UNet2D body by ``cfg.block``, the head's BatchNorms with
    their statistics, its convs, PAM's query/key/value convs and both
    gammas, and the three heads no output reads."""
    t = _Walk(variables["params"], variables.get("batch_stats"))
    block = _block_kind(cfg.get("block"))
    _unet_encoder(t, block, 2)
    da = "DAHead_0"
    for i, name in enumerate(DAHEAD_PAIRS):
        tkey = f"DAModule.{name}"
        t.bn((da, f"Norm_{i}"), f"{tkey}.0")
        t.conv((da, f"Conv_{i}", "kernel"), f"{tkey}.2.weight")
        if t.has((da, f"Conv_{i}", "bias")):
            t.raw((da, f"Conv_{i}", "bias"), f"{tkey}.2.bias")
    for c, name in enumerate(("query_conv", "key_conv", "value_conv")):
        t.conv((da, "PAM_0", f"Conv_{c}", "kernel"),
               f"DAModule.sa.{name}.weight")
        t.raw((da, "PAM_0", f"Conv_{c}", "bias"), f"DAModule.sa.{name}.bias")
    t.raw((da, "PAM_0", "gamma"), "DAModule.sa.gamma")
    t.raw((da, "CAM_0", "gamma"), "DAModule.sc.gamma")
    for c, name in enumerate(DAHEAD_HEADS):
        t.conv((da, f"Conv_{4 + c}", "kernel"), f"DAModule.{name}.1.weight")
        t.raw((da, f"Conv_{4 + c}", "bias"), f"DAModule.{name}.1.bias")
    _unet_decoder(t, block, "UpBlock2D", 2)
    return t.state_dict()


#: VNet's transitions in the Flax tree's order, with their LUConv counts
VNET_DOWNS = (("down_tr32", 1), ("down_tr64", 2), ("down_tr128", 3),
              ("down_tr256", 2))
VNET_UPS = (("up_tr256", 2), ("up_tr128", 2), ("up_tr64", 1), ("up_tr32", 1))


def vnet_state_dict_from_jax(params) -> dict:
    """Flax VNet params -> state_dict (the keys ``import_vnet`` reads);
    the PReLU slopes where the tree has them (elu=False)."""
    t = _Walk(params)

    def conv(path, tkey, transpose=False):
        (t.conv_transpose if transpose else t.conv)((*path, "kernel"),
                                                     f"{tkey}.weight")
        t.raw((*path, "bias"), f"{tkey}.bias")

    def cbn(node, tkey):
        t.raw((*node, "ContBatchNorm_0", "scale"), f"{tkey}.weight")
        t.raw((*node, "ContBatchNorm_0", "bias"), f"{tkey}.bias")

    def act(node, name, tkey):
        if t.has((*node, name, "prelu")):
            t.raw((*node, name, "prelu"), f"{tkey}.weight")

    def lu_convs(node, tkey, n):
        for k in range(n):
            lu = (*node, f"LUConv_{k}")
            conv((*lu, "Conv_0"), f"{tkey}.ops.{k}.conv1")
            cbn(lu, f"{tkey}.ops.{k}.bn1")
            act(lu, "_Act_0", f"{tkey}.ops.{k}.relu1")

    it = ("InputTransition_0",)
    conv((*it, "Conv_0"), "in_tr.conv1")
    cbn(it, "in_tr.bn1")
    act(it, "_Act_0", "in_tr.relu1")
    for i, (tkey, n) in enumerate(VNET_DOWNS):
        node = (f"DownTransition_{i}",)
        conv((*node, "Conv_0"), f"{tkey}.down_conv")
        cbn(node, f"{tkey}.bn1")
        act(node, "_Act_0", f"{tkey}.relu1")
        act(node, "_Act_1", f"{tkey}.relu2")
        lu_convs(node, tkey, n)
    for i, (tkey, n) in enumerate(VNET_UPS):
        node = (f"UpTransition_{i}",)
        conv((*node, "ConvTranspose_0"), f"{tkey}.up_conv", transpose=True)
        cbn(node, f"{tkey}.bn1")
        act(node, "_Act_0", f"{tkey}.relu1")
        act(node, "_Act_1", f"{tkey}.relu2")
        lu_convs(node, tkey, n)
    conv(("Conv_0",), "out_tr.conv1")
    cbn((), "out_tr.bn1")
    act((), "_Act_0", "out_tr.relu1")
    conv(("Conv_1",), "out_tr.conv2")
    return t.state_dict()


#: UNETR's transposed convs in the Flax tree's order (``_TranspConv_{i}``)
UNETR_TRANSP_CONVS = (
    "encoder2.transp_conv_init", "encoder2.blocks.0", "encoder2.blocks.1",
    "encoder3.transp_conv_init", "encoder3.blocks.0",
    "encoder4.transp_conv_init", "decoder5.transp_conv",
    "decoder4.transp_conv", "decoder3.transp_conv", "decoder2.transp_conv")


def walk_vit(t: _Walk) -> None:
    """UNETR's ``ViT_0`` -> ``vit.*``: the patch embedding, each block's
    norms, qkv (no bias), out_proj and MLP, the final norm."""
    vit = ("ViT_0",)
    pe = (*vit, "PatchEmbedding_0")
    t.dense((*pe, "Dense_0"), "vit.patch_embedding.proj")
    t.raw((*pe, "position_embeddings"),
          "vit.patch_embedding.position_embeddings")
    n = sum(1 for k in t.params["ViT_0"] if k.startswith("Attention_"))
    for i in range(n):
        tkey = f"vit.blocks.{i}"
        t.layer_norm((*vit, f"LayerNorm_{2 * i}"), f"{tkey}.norm1")
        t.dense((*vit, f"Attention_{i}", "Dense_0"), f"{tkey}.attn.qkv",
                bias=False)
        t.dense((*vit, f"Attention_{i}", "Dense_1"), f"{tkey}.attn.out_proj")
        t.layer_norm((*vit, f"LayerNorm_{2 * i + 1}"), f"{tkey}.norm2")
        t.dense((*vit, f"Mlp_{i}", "Dense_0"), f"{tkey}.mlp.linear1")
        t.dense((*vit, f"Mlp_{i}", "Dense_1"), f"{tkey}.mlp.linear2")
    t.layer_norm((*vit, f"LayerNorm_{2 * n}"), "vit.norm")


def unetr_state_dict_from_jax(params) -> dict:
    """Flax UNETR params -> state_dict (the keys ``import_unetr`` reads)."""
    t = _Walk(params)
    walk_vit(t)
    t.unet_res_block(("UnetResBlock_0",), "encoder1.layer")
    for i, tkey in enumerate(UNETR_TRANSP_CONVS):
        t.conv_transpose((f"_TranspConv_{i}", "ConvTranspose_0", "kernel"),
                         f"{tkey}.weight")
    for i, dec in enumerate(("decoder5", "decoder4", "decoder3",
                             "decoder2")):
        t.unet_res_block((f"UnetResBlock_{i + 1}",), f"{dec}.conv_block")
    t.conv(("Conv_0", "kernel"), "out.conv.weight")
    t.raw(("Conv_0", "bias"), "out.conv.bias")
    return t.state_dict()


TRANSUNET_UNITS = (3, 4, 9)


def _transunet_units():
    """(reference unit key, its index k in the Flax tree, whether it
    projects the residual) for the R50's 16 units."""
    k = 0
    for bi, units in enumerate(TRANSUNET_UNITS):
        for u in range(1, units + 1):
            yield f"block{bi + 1}.unit{u}", k, u == 1
            k += 1


def transunet_state_dict_from_jax(variables) -> dict:
    """Flax TransUNet variables -> state_dict (the keys
    ``import_transunet`` reads): the R50 stem's StdConvs and GroupNorms
    (a projecting unit's ``downsample`` and ``gn_proj`` first in the Flax
    tree), the patch conv and position embedding, each ViT layer with the
    fused qkv ``Dense_0`` split back into ``query``, ``key`` and ``value``,
    the encoder norm, the decoder's convs and BatchNorms (statistics
    included) and the head."""
    t = _Walk(variables["params"], variables.get("batch_stats"))
    hm = "transformer.embeddings.hybrid_model"
    rn = ("ResNetV2_0",)
    t.conv((*rn, "StdConv_0", "kernel"), f"{hm}.root.conv.weight")
    t.layer_norm((*rn, "GN_0"), f"{hm}.root.gn")
    for tkey, k, proj in _transunet_units():
        unit, tkey = (*rn, f"PreActBottleneck_{k}"), f"{hm}.body.{tkey}"
        names = ((("downsample", "gn_proj"),) if proj else ()) + tuple(
            (f"conv{c}", f"gn{c}") for c in (1, 2, 3))
        for j, (conv, gn) in enumerate(names):
            t.conv((*unit, f"StdConv_{j}", "kernel"), f"{tkey}.{conv}.weight")
            t.layer_norm((*unit, f"GN_{j}"), f"{tkey}.{gn}")
    emb = "transformer.embeddings"
    t.conv(("Conv_0", "kernel"), f"{emb}.patch_embeddings.weight")
    t.raw(("Conv_0", "bias"), f"{emb}.patch_embeddings.bias")
    t.raw(("position_embeddings",), f"{emb}.position_embeddings")
    n = sum(1 for k in t.params if k.startswith("Attention_"))
    for i in range(n):
        tkey = f"transformer.encoder.layer.{i}"
        t.layer_norm((f"LayerNorm_{2 * i}",), f"{tkey}.attention_norm")
        qkv = t._get(t.params, (f"Attention_{i}", "Dense_0"))
        for w, b, name in zip(np.split(np.asarray(qkv["kernel"]), 3, axis=1),
                              np.split(np.asarray(qkv["bias"]), 3),
                              ("query", "key", "value")):
            t.sd[f"{tkey}.attn.{name}.weight"] = w.T
            t.sd[f"{tkey}.attn.{name}.bias"] = b
        t.dense((f"Attention_{i}", "Dense_1"), f"{tkey}.attn.out")
        t.layer_norm((f"LayerNorm_{2 * i + 1}",), f"{tkey}.ffn_norm")
        t.dense((f"Mlp_{i}", "Dense_0"), f"{tkey}.ffn.fc1")
        t.dense((f"Mlp_{i}", "Dense_1"), f"{tkey}.ffn.fc2")
    t.layer_norm((f"LayerNorm_{2 * n}",), "transformer.encoder.encoder_norm")
    convs = ["decoder.conv_more"] + [f"decoder.blocks.{i}.conv{c}"
                                     for i in range(4) for c in (1, 2)]
    for i, tkey in enumerate(convs):
        t.conv((f"Conv_{i + 1}", "kernel"), f"{tkey}.0.weight")
        t.batch_norm((f"BatchNorm_{i}",), f"{tkey}.1")
    t.conv((f"Conv_{len(convs) + 1}", "kernel"), "segmentation_head.0.weight")
    t.raw((f"Conv_{len(convs) + 1}", "bias"), "segmentation_head.0.bias")
    return t.state_dict()


def transunet_npz_state_dict(npz, position_shape) -> dict:
    """The official R50+ViT-B_16 ``.npz`` (``npz``: a mapping of its keys
    to arrays) as the port's TransUNet keys, the counterpart of
    ``cbim_tpu.utils.torch_import.import_transunet_npz`` (the reference's
    ``load_from``): HWIO convs to OIHW, each per-head (hidden, heads,
    dim_head) query/key/value kernel and (heads, dim_head, hidden) out
    kernel to a (hidden, hidden) Linear weight, and the position embedding
    fitted to ``position_shape`` (1, tokens, hidden): the cls token dropped
    where the file has one token more, else the grid (cls dropped) zoomed
    bilinearly (``scipy.ndimage.zoom``, order 1).  The hybrid stem where
    the file has ``conv_root/kernel``.  The decoder and the head are not in
    the file: they keep their values (load non-strictly)."""
    w = {k: np.asarray(npz[k]) for k in
         (npz.files if hasattr(npz, "files") else npz.keys())}
    sd = {}

    def conv(key):
        return w[key].transpose(3, 2, 0, 1)

    def vec(key):
        return w[key].reshape(-1)

    hidden = w["embedding/kernel"].shape[-1]
    emb = "transformer.embeddings"
    sd[f"{emb}.patch_embeddings.weight"] = conv("embedding/kernel")
    sd[f"{emb}.patch_embeddings.bias"] = w["embedding/bias"]
    sd["transformer.encoder.encoder_norm.weight"] =         vec("Transformer/encoder_norm/scale")
    sd["transformer.encoder.encoder_norm.bias"] =         vec("Transformer/encoder_norm/bias")
    posemb = w["Transformer/posembed_input/pos_embedding"]
    tgt = tuple(position_shape)
    if posemb.shape != tgt:
        if posemb.shape[1] - 1 == tgt[1]:
            posemb = posemb[:, 1:]
        else:
            from scipy import ndimage
            grid = posemb[0, 1:]
            gs_old, gs_new = int(np.sqrt(grid.shape[0])), int(np.sqrt(tgt[1]))
            grid = ndimage.zoom(grid.reshape(gs_old, gs_old, -1),
                                (gs_new / gs_old, gs_new / gs_old, 1),
                                order=1)
            posemb = grid.reshape(1, gs_new * gs_new, -1)
    sd[f"{emb}.position_embeddings"] = posemb

    n_layers = sum(1 for k in w if k.startswith("Transformer/encoderblock_")
                   and k.endswith("LayerNorm_0/scale"))
    attn = "MultiHeadDotProductAttention_1"
    for i in range(n_layers):
        src = f"Transformer/encoderblock_{i}"
        tkey = f"transformer.encoder.layer.{i}"
        for name in ("query", "key", "value", "out"):
            sd[f"{tkey}.attn.{name}.weight"] =                 w[f"{src}/{attn}/{name}/kernel"].reshape(hidden, hidden).T
            sd[f"{tkey}.attn.{name}.bias"] = vec(f"{src}/{attn}/{name}/bias")
        for j, fc in ((0, "fc1"), (1, "fc2")):
            sd[f"{tkey}.ffn.{fc}.weight"] =                 w[f"{src}/MlpBlock_3/Dense_{j}/kernel"].T
            sd[f"{tkey}.ffn.{fc}.bias"] =                 vec(f"{src}/MlpBlock_3/Dense_{j}/bias")
        for j, norm in ((0, "attention_norm"), (2, "ffn_norm")):
            sd[f"{tkey}.{norm}.weight"] = vec(f"{src}/LayerNorm_{j}/scale")
            sd[f"{tkey}.{norm}.bias"] = vec(f"{src}/LayerNorm_{j}/bias")

    if "conv_root/kernel" in w:
        hm = f"{emb}.hybrid_model"
        sd[f"{hm}.root.conv.weight"] = conv("conv_root/kernel")
        sd[f"{hm}.root.gn.weight"] = vec("gn_root/scale")
        sd[f"{hm}.root.gn.bias"] = vec("gn_root/bias")
        for tkey, _, proj in _transunet_units():
            src, tkey = tkey.replace(".", "/"), f"{hm}.body.{tkey}"
            names = [(f"conv{c}", f"gn{c}") for c in (1, 2, 3)]
            if proj:
                names.append(("conv_proj", "gn_proj"))
            for conv_name, gn in names:
                dst = "downsample" if conv_name == "conv_proj" else conv_name
                sd[f"{tkey}.{dst}.weight"] = conv(f"{src}/{conv_name}/kernel")
                sd[f"{tkey}.{gn}.weight"] = vec(f"{src}/{gn}/scale")
                sd[f"{tkey}.{gn}.bias"] = vec(f"{src}/{gn}/bias")
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in sd.items()}


def _host(tree):
    """A tree's leaves as numpy arrays (bfloat16 tensors of the msgpack
    reader widened to float32)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(tree)


def state_dict_from_jax(cfg, variables) -> dict:
    """The port's state_dict for Flax ``variables`` ({"params", and
    "batch_stats" for BatchNorm models}, nested dicts of arrays) of the
    model ``cfg`` selects: the dispatch of ``import_for_model``, inverted,
    over every ported (dimension, model).  An unported pair raises
    NotImplementedError; params that do not fit the model raise
    ValueError."""
    variables = _host(variables)
    params = variables["params"]
    dim, name = cfg.dimension, cfg.model
    walks = {
        ("3d", "medformer"): lambda: medformer3d_state_dict_from_jax(
            params, cfg, variables.get("batch_stats")),
        ("2d", "medformer"): lambda: medformer2d_state_dict_from_jax(
            variables, cfg),
        ("3d", "swin_unetr"): lambda: swin_unetr_state_dict_from_jax(params),
        ("3d", "vtunet"): lambda: vtunet_state_dict_from_jax(params),
        ("3d", "nnformer"): lambda: nnformer_state_dict_from_jax(params),
        ("2d", "swinunet"): lambda: swinunet_state_dict_from_jax(params),
        ("3d", "unet"): lambda: unet3d_state_dict_from_jax(variables, cfg),
        ("3d", "resunet"): lambda: unet3d_state_dict_from_jax(variables, cfg),
        ("3d", "unet++"): lambda: unetpp3d_state_dict_from_jax(variables,
                                                               cfg),
        ("3d", "attention_unet"): lambda: attention_unet3d_state_dict_from_jax(
            variables, cfg),
        ("3d", "vnet"): lambda: vnet_state_dict_from_jax(params),
        ("3d", "unetr"): lambda: unetr_state_dict_from_jax(params),
        ("2d", "unet"): lambda: unet2d_state_dict_from_jax(variables, cfg),
        ("2d", "resunet"): lambda: unet2d_state_dict_from_jax(variables,
                                                              cfg),
        ("2d", "unet++"): lambda: unetpp2d_state_dict_from_jax(variables),
        ("2d", "attention_unet"): lambda: attention_unet2d_state_dict_from_jax(
            variables),
        ("2d", "daunet"): lambda: daunet_state_dict_from_jax(variables, cfg),
        ("2d", "transunet"): lambda: transunet_state_dict_from_jax(variables),
    }
    if (dim, name) not in walks:
        raise NotImplementedError(
            f"loading Flax variables of {name!r} ({dim}) is not ported yet "
            f"(see ROADMAP.md)")
    try:
        return walks[dim, name]()
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError(
            f"the Flax variables do not fit the config's model {name!r} "
            f"({dim}): no {e} where the model's tree has it") from None
