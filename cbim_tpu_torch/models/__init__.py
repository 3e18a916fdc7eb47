"""Model factory (counterpart of ``cbim_tpu/models/__init__.py``).

MedFormer-3D, MedFormer-2D and SwinUNETR (serving only) are ported; every
other (model, dimension) raises ``NotImplementedError`` (the rest of the zoo
is queued in ROADMAP.md).
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
PORTED = (("3d", "medformer"), ("2d", "medformer"), ("3d", "swin_unetr"))


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
            f"covers MedFormer-3D, MedFormer-2D and SwinUNETR serving (see "
            f"ROADMAP.md)")
    if name == "swin_unetr" and train:
        raise NotImplementedError(
            "SwinUNETR training is not ported yet (ROADMAP.md, queue A: "
            "SwinUNETR training; the window-attention kernel has no "
            "backward)")
    device = get_device(device)
    if name == "swin_unetr":
        model = _swin_unetr(cfg)
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
    model's BatchNorm + ReLU defaults), no remat."""
    from .medformer import MedFormer2D
    return MedFormer2D(
        in_chan=cfg.in_chan, num_classes=cfg.classes, base_ch=cfg.base_chan,
        map_size=cfg.map_size, conv_block=cfg.conv_block,
        conv_num=tuple(cfg.conv_num), trans_num=tuple(cfg.trans_num),
        num_heads=tuple(cfg.num_heads), fusion_depth=cfg.fusion_depth,
        fusion_dim=cfg.fusion_dim, fusion_heads=cfg.fusion_heads,
        expansion=cfg.expansion, proj_type=cfg.proj_type,
        aux_loss=cfg.aux_loss, attn_drop=cfg.get("attn_drop", 0.0),
        proj_drop=cfg.get("proj_drop", 0.0))


def _swin_unetr(cfg) -> nn.Module:
    """The JAX factory's SwinUNETR: img_size = the window, feature_size =
    base_chan, the model's defaults for the rest."""
    from .swin_unetr import SwinUNETR
    return SwinUNETR(in_chan=cfg.in_chan, num_classes=cfg.classes,
                     img_size=tuple(cfg.window_size or cfg.training_size),
                     feature_size=cfg.base_chan)


def _medformer3d(cfg) -> nn.Module:
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
        aux_loss=cfg.aux_loss, remat=cfg.get("remat", False),
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
    them, the affine instance norms' weight U(0.5, 1.5) and bias
    U(-0.5, 0.5)."""
    for name, p in model.named_parameters():
        if name.endswith("relative_position_bias_table"):
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
        elif isinstance(m, InstanceNormAffine):
            m.weight.uniform_(0.5, 1.5, generator=generator)
            m.bias.uniform_(-0.5, 0.5, generator=generator)
