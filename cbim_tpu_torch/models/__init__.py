"""Model factory (counterpart of ``cbim_tpu/models/__init__.py``).

Ported, for serving and training: in 3D MedFormer, UNet and ResUNet,
UNet++, AttentionUNet, VNet, UNETR, SwinUNETR, VT-UNet and nnFormer; in 2D
MedFormer, SwinUnet, UNet and ResUNet, UNet++, AttentionUNet, DAUNet and
TransUNet: the JAX factory's whole zoo.  Another (model, dimension) raises
``NotImplementedError``, and so do the blocks and options the port does
not carry yet (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import compute_dtype, set_float32_precision
from ..ops._backend import get_device
from .layers.convs import CHANNELS_LAST
from .unetr import InstanceNormAffine

#: the full-width MedFormer-3D stage widths (``cbim_tpu``'s default)
DEFAULT_CHAN_NUM = [64, 128, 256, 320, 256, 128, 64, 32]


def _norm_scales(v, n):
    """Normalize scalar / flat-list / nested-list axis specs to n per-level
    lists (same rule as ``cbim_tpu.models._norm_scales``)."""
    if isinstance(v, int):
        return [[v] * 3] * n
    v = list(v)
    if all(isinstance(t, int) for t in v):
        if len(v) == n:
            return [[t] * 3 for t in v]
        return [list(v)] * n
    assert len(v) == n, (v, n)
    return [list(t) for t in v]


#: the (dimension, model) pairs the port builds
PORTED = (("3d", "medformer"), ("2d", "medformer"), ("3d", "swin_unetr"),
          ("3d", "vtunet"), ("3d", "nnformer"), ("2d", "swinunet"),
          ("3d", "unet"), ("3d", "resunet"), ("3d", "unet++"),
          ("3d", "attention_unet"), ("3d", "vnet"), ("3d", "unetr"),
          ("2d", "unet"), ("2d", "resunet"), ("2d", "unet++"),
          ("2d", "attention_unet"), ("2d", "daunet"), ("2d", "transunet"))


def get_model(cfg, device="cuda", generator: torch.Generator | None = None,
              train: bool = False) -> nn.Module:
    """Build the model selected by (cfg.dimension, cfg.model) in
    channels-last memory (channels_last_3d for 3D) on ``device``: the card
    unless the caller asks for the CPU ('cuda' without a usable sm_90 card
    raises).

    ``train=False`` (serving): eval mode (BatchNorm reads its running
    statistics), parameters in cfg's compute dtype.
    ``train=True``: train mode with fp32 parameters; the trainer computes in
    bf16 under ``torch.autocast`` when cfg asks for amp, as the JAX package
    keeps fp32 params and optimizer state around bf16 compute.

    ``generator``: re-draw every parameter from it with torch's default
    initialisation (seeded random weights)."""
    dim, name = cfg.dimension, cfg.model
    if (dim, name) not in PORTED:
        raise NotImplementedError(
            f"model {name!r} ({dim}) is not ported yet; the PyTorch port "
            f"covers {', '.join(f'{m} ({d})' for d, m in PORTED)} (see "
            f"ROADMAP.md)")
    device = get_device(device)
    if dim == "3d" and name in ZOO_3D:
        model = ZOO_3D[name](cfg)
    elif dim == "2d" and name in ZOO_2D:
        model = ZOO_2D[name](cfg)
    elif name == "swin_unetr":
        model = _swin_unetr(cfg)
    elif name == "vtunet":
        model = _vtunet(cfg)
    elif name == "nnformer":
        model = _nnformer(cfg)
    elif name == "swinunet":
        model = _swinunet(cfg)
    else:
        model = (_medformer2d if dim == "2d" else _medformer3d)(cfg)
    if generator is not None:
        init_weights(model, generator)
    set_float32_precision(cfg)
    dtype = torch.float32 if train else compute_dtype(cfg)
    model = model.to(device=device, dtype=dtype,
                     memory_format=CHANNELS_LAST[2 if dim == "2d" else 3])
    for m in model.modules():
        # grouped 3D convs run in contiguous memory (layers.convs.
        # grouped_conv); load_state_dict copies into the parameter and keeps
        # this layout.  Not .contiguous(): a depthwise weight [C, 1, 3, 3, 3]
        # passes is_contiguous() with channels_last_3d strides, which steer
        # the conv to the slow layout all the same.
        if isinstance(m, nn.Conv3d) and m.groups > 1:
            m.weight.data = m.weight.data.clone(
                memory_format=torch.contiguous_format)
    return model.train(train)


def _medformer2d(cfg) -> nn.Module:
    """The JAX factory's MedFormer2D: no norm or act from the config (the
    model's BatchNorm + ReLU defaults), no remat; the 3x3 kernel route only
    with ``conv2d_kernel`` (default off, as JAX's ``CBIM_PLCONV2D``)."""
    from .medformer import MedFormer2D
    return MedFormer2D(
        in_chan=cfg.in_chan, num_classes=cfg.classes, base_ch=cfg.base_chan,
        map_size=cfg.map_size, conv_block=cfg.conv_block,
        conv_num=tuple(cfg.conv_num), trans_num=tuple(cfg.trans_num),
        num_heads=tuple(cfg.num_heads), fusion_depth=cfg.fusion_depth,
        fusion_dim=cfg.fusion_dim, fusion_heads=cfg.fusion_heads,
        expansion=cfg.expansion, proj_type=cfg.proj_type,
        aux_loss=cfg.aux_loss, attn_drop=cfg.get("attn_drop", 0.0),
        proj_drop=cfg.get("proj_drop", 0.0),
        conv2d_kernel=cfg.get("conv2d_kernel", False))


def _swin_unetr(cfg) -> nn.Module:
    """The JAX factory's SwinUNETR: img_size = the window, feature_size =
    base_chan, the model's defaults for the rest."""
    from .swin_unetr import SwinUNETR
    return SwinUNETR(in_chan=cfg.in_chan, num_classes=cfg.classes,
                     img_size=tuple(cfg.window_size or cfg.training_size),
                     feature_size=cfg.base_chan)


def _vtunet(cfg) -> nn.Module:
    """The JAX factory's VTUNet: ``cfg.patch_size``, the model's defaults
    for the rest (embedding 96, depths (2, 2, 2, 1), windows of 7, drop-path
    rate 0.1); ``embed_dim`` and ``drop_path_rate`` are optional config
    overrides (the small CPU and card checks)."""
    from .vtunet import DROP_PATH_RATE, EMBED_DIM, VTUNet
    rate = cfg.get("drop_path_rate")
    return VTUNet(in_chan=cfg.in_chan, num_classes=cfg.classes,
                  patch_size=tuple(cfg.patch_size),
                  embed_dim=cfg.get("embed_dim") or EMBED_DIM,
                  drop_path_rate=DROP_PATH_RATE if rate is None else rate)


def _nnformer(cfg) -> nn.Module:
    """The JAX factory's NNFormer: crop_size = the window, deep supervision
    = aux_loss, the model's defaults (embedding 192, heads (6, 12, 24, 48),
    patch (2, 4, 4), windows (4, 4, 8, 4), drop-path rate 0.2) unless the
    config sets ``embedding_dim``, ``nnformer_num_heads``, ``patch_size``,
    ``nnformer_window_size`` or ``drop_path_rate``."""
    from .nnformer import NNFormer
    kw = {}
    for key, arg in (("embedding_dim", "embedding_dim"),
                     ("patch_size", "patch_size"),
                     ("drop_path_rate", "drop_path_rate"),
                     ("nnformer_num_heads", "num_heads"),
                     ("nnformer_window_size", "window_size")):
        v = cfg.get(key)
        if v is not None:
            kw[arg] = tuple(v) if isinstance(v, list) else v
    return NNFormer(in_chan=cfg.in_chan, num_classes=cfg.classes,
                    crop_size=tuple(cfg.window_size or cfg.training_size),
                    deep_supervision=bool(cfg.aux_loss), **kw)


def _swinunet(cfg) -> nn.Module:
    """The JAX factory's SwinUnet2D: img_size 224, the model's defaults
    (embedding 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24), windows of
    7, drop-path rate 0.1); ``embed_dim`` and ``drop_path_rate`` are
    optional config overrides, as for VT-UNet (the small CPU and card
    checks)."""
    from .swin_unet import DROP_PATH_RATE, EMBED_DIM, SwinUnet2D
    rate = cfg.get("drop_path_rate")
    return SwinUnet2D(in_chan=cfg.in_chan, num_classes=cfg.classes,
                      img_size=224,
                      embed_dim=cfg.get("embed_dim") or EMBED_DIM,
                      drop_path_rate=DROP_PATH_RATE if rate is None else rate)


def _unet_family_args(cfg) -> dict:
    """The UNet family's factory arguments: base_chan, the per-level
    pooling scales and kernels (``_norm_scales``), block and norm."""
    return dict(in_chan=cfg.in_chan, num_classes=cfg.classes,
                base_ch=cfg.base_chan,
                scale=tuple(map(tuple, _norm_scales(cfg.down_scale, 4))),
                kernel_size=tuple(map(tuple, _norm_scales(cfg.kernel_size,
                                                          5))),
                block=cfg.block, norm=cfg.norm)


def _unet3d(cfg) -> nn.Module:
    """The JAX factory's UNet3D (unet and resunet alike: ``cfg.block``
    picks the block), its act the model's default ReLU."""
    from .unet import UNet3D
    return UNet3D(**_unet_family_args(cfg))


def _unetpp3d(cfg) -> nn.Module:
    from .unetpp import UNetPlusPlus3D
    return UNetPlusPlus3D(**_unet_family_args(cfg))


def _attention_unet3d(cfg) -> nn.Module:
    from .attention_unet import AttentionUNet3D
    return AttentionUNet3D(**_unet_family_args(cfg))


def _vnet(cfg) -> nn.Module:
    """The JAX factory's VNet: base_chan, the model's defaults (ELU,
    pooling scales 2)."""
    from .vnet import VNet
    return VNet(in_chan=cfg.in_chan, num_classes=cfg.classes,
                base_ch=cfg.base_chan)


def _unetr(cfg) -> nn.Module:
    """The JAX factory's UNETR: img_size = training_size, feature size 16,
    hidden 768, MLP 3072, 12 heads; ``feature_size``, ``hidden_size``,
    ``mlp_dim`` and ``unetr_num_heads`` are optional config overrides (the
    small CPU and card checks)."""
    from .unetr import UNETR
    return UNETR(in_chan=cfg.in_chan, num_classes=cfg.classes,
                 img_size=tuple(cfg.training_size),
                 feature_size=cfg.get("feature_size") or 16,
                 hidden_size=cfg.get("hidden_size") or 768,
                 mlp_dim=cfg.get("mlp_dim") or 3072,
                 num_heads=cfg.get("unetr_num_heads") or 12)


#: the 3D zoo's factory functions by model name
ZOO_3D = {"unet": _unet3d, "resunet": _unet3d, "unet++": _unetpp3d,
          "attention_unet": _attention_unet3d, "vnet": _vnet,
          "unetr": _unetr}


def _cnn2d_args(cfg, block: bool = False) -> dict:
    """The 2D CNNs' factory arguments: base_chan, and the 3x3 kernel route
    only with ``conv2d_kernel`` (default off, as JAX's ``CBIM_PLCONV2D``);
    no norm or act from the config (BatchNorm, ReLU).  ``block``: the
    config's block too (``YAML_DEFAULTS``: ConvNormAct, SingleConv)."""
    args = dict(in_chan=cfg.in_chan, num_classes=cfg.classes,
                base_ch=cfg.base_chan,
                conv2d_kernel=cfg.get("conv2d_kernel", False))
    if block:
        args["block"] = cfg.block
    return args


def _unet2d(cfg) -> nn.Module:
    """The JAX factory's UNet2D: unet and resunet alike, ``cfg.block``
    picks the block."""
    from .unet import UNet2D
    return UNet2D(**_cnn2d_args(cfg, block=True))


def _unetpp2d(cfg) -> nn.Module:
    from .unetpp import UNetPlusPlus2D
    return UNetPlusPlus2D(**_cnn2d_args(cfg))


def _attention_unet2d(cfg) -> nn.Module:
    from .attention_unet import AttentionUNet2D
    return AttentionUNet2D(**_cnn2d_args(cfg))


def _daunet(cfg) -> nn.Module:
    from .daunet import DAUNet2D
    return DAUNet2D(**_cnn2d_args(cfg, block=True))


def _transunet(cfg) -> nn.Module:
    """The JAX factory's TransUNet: grid = training_size / 16 (the
    factory's img_size, training_size[0], sizes nothing else),
    R50-ViT-B/16 (hidden 768, MLP 3072, 12 layers, 12 heads, dropout 0.1);
    ``hidden_size``, ``mlp_dim``, ``num_layers``, ``transunet_num_heads``
    and ``dropout_rate`` are optional config overrides (the small CPU and
    card checks)."""
    from . import transunet as tu
    ts = cfg.training_size
    rate = cfg.get("dropout_rate")
    return tu.TransUNet(
        in_chan=cfg.in_chan, num_classes=cfg.classes,
        grid=(int(ts[0] / 16), int(ts[1] / 16)),
        hidden_size=cfg.get("hidden_size") or tu.HIDDEN_SIZE,
        mlp_dim=cfg.get("mlp_dim") or tu.MLP_DIM,
        num_layers=cfg.get("num_layers") or tu.NUM_LAYERS,
        num_heads=cfg.get("transunet_num_heads") or tu.NUM_HEADS,
        dropout=tu.DROPOUT if rate is None else rate)


#: the 2D zoo's factory functions by model name (MedFormer-2D and SwinUnet
#: have their own)
ZOO_2D = {"unet": _unet2d, "resunet": _unet2d, "unet++": _unetpp2d,
          "attention_unet": _attention_unet2d, "daunet": _daunet,
          "transunet": _transunet}


def _medformer3d(cfg) -> nn.Module:
    """The JAX factory's MedFormer3D; remat of every stage unless the
    config says otherwise (its mode strings, 'highres' among them, pass as
    they are)."""
    from .medformer import MedFormer3D
    return MedFormer3D(
        in_chan=cfg.in_chan, num_classes=cfg.classes, base_ch=cfg.base_chan,
        map_size=tuple(cfg.map_size), conv_block=cfg.conv_block,
        conv_num=tuple(cfg.conv_num), trans_num=tuple(cfg.trans_num),
        chan_num=tuple(cfg.get("chan_num") or DEFAULT_CHAN_NUM),
        num_heads=tuple(cfg.num_heads), fusion_depth=cfg.fusion_depth,
        fusion_dim=cfg.fusion_dim, fusion_heads=cfg.fusion_heads,
        expansion=cfg.expansion, proj_type=cfg.proj_type, norm=cfg.norm,
        act=cfg.act,
        kernel_size=tuple(map(tuple, _norm_scales(cfg.kernel_size, 5))),
        scale=tuple(map(tuple, _norm_scales(cfg.down_scale, 4))),
        aux_loss=cfg.aux_loss, remat=cfg.get("remat", True),
        attn_drop=cfg.get("attn_drop", 0.0),
        proj_drop=cfg.get("proj_drop", 0.0),
        conv_na=cfg.get("conv_na", False))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default init drawn from ``generator``: conv, transposed-conv
    and linear weights and biases U(+-1/sqrt(fan_in)) (kaiming_uniform(a=
    sqrt(5)); a transposed conv's fan_in is its dim 1 times its kernel),
    LayerNorm weight 1 and bias 0 (BatchNorm keeps its own: weight 1, bias
    0).  The Swin family's parameters that torch's default leaves constant
    are drawn too, so that seeded weights exercise them: the relative
    position bias tables trunc_normal(std 0.02) as the reference inits
    them, and UNETR's position embedding alike; the affine instance norms'
    and VNet's ContBatchNorms' weight U(0.5, 1.5) and bias U(-0.5, 0.5)."""
    from .vnet import ContBatchNorm
    for name, p in model.named_parameters():
        if name.endswith(("relative_position_bias_table",
                          "position_embeddings")):
            nn.init.trunc_normal_(p, std=0.02, generator=generator)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                          nn.Linear)):
            fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, (InstanceNormAffine, ContBatchNorm)):
            m.weight.uniform_(0.5, 1.5, generator=generator)
            m.bias.uniform_(-0.5, 0.5, generator=generator)
