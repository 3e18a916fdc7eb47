"""Convolutional building blocks (counterpart of
``cbim_tpu/models/layers/convs.py``), as ``nn.Module``s over NCHW / NCDHW
tensors, one implementation for both ranks (``nd`` = 2 or 3).

Parameter names follow the reference's torch modules (``conv``, ``norm``,
``conv1``/``conv2``/``shortcut``, ``depthwise``/``pointwise``,
``expand_proj``, ``se.excitation``, and ``se_block.excitation`` in the dim2
MBConv), so a state_dict maps onto the Flax tree through
``cbim_tpu.utils.torch_import`` unchanged.  The blocks that importer does
not map take names chosen here, each in its class's docstring:
``Bottleneck`` the reference's ``conv1``/``conv2``/``conv3``/``shortcut``
(conv_layers.py:97-123), ``FusedMBConv`` and ``ConvNeXtBlock`` their own
(no reference state_dict of either has been loaded).

Kernel dispatch, one rule per kernel family; each trains through its
``torch.autograd.Function`` (backward kernels on CUDA):
- every InstanceNorm(+act) goes through ``InstanceNormAct`` (fused kernels
  on CUDA, any C);
- a ``ConvNormAct`` conv that is 3^3 and not grouped, with C_in <= 192
  and C_out <= 128 (the envelope of the TPU dispatch,
  ``_pallas_conv_usable``), goes through ``Conv3dSame``;
- with ``conv2d_kernel``, a ``ConvNormAct`` conv that is 3x3 and not
  grouped, with C_in <= 192 and C_out <= 192 (``_pallas_conv2d_usable``'s
  channel envelope), goes through ``Conv2dSame`` at any H, W: the JAX
  package's opt-in ``CBIM_PLCONV2D=1`` route.  Without it (the default, as
  in JAX) the 3x3 convs are ``F.conv2d`` (cuDNN);
- with ``conv_na``, a preact InstanceNorm ``ConvNormAct`` whose conv takes
  ``Conv3dSame`` and whose act the norm kernels fuse goes through
  ``ConvInormAct3d`` instead, norm and conv as one: the JAX package's
  opt-in ``CBIM_CONV_NA=1`` route (``_PallasConvCWNA``).
BatchNorm stays ``F.batch_norm`` (``torch.native_batch_norm`` when
training), as XLA carried Flax's; under data parallelism a training-mode
BatchNorm marked with the run's process group (``sync_batch_norm``)
normalises with the global batch's statistics (``global_batch_norm``).
Under the 'spatial' mesh axis a model marked with the spatial group
(``spatial_shard``) trains on H slabs: every conv whose kernel spans more
than one row of H runs on its slab and the neighbours' halo planes (the
3^3 kernel route, cuDNN's convs and ``grouped_conv`` alike, through
``_conv`` and ``parallel.spatial.halo_conv``), InstanceNorm and the fused
preact conv take the whole volume's statistics on the same kernels
(``SpatialInstanceNormAct``, ``SpatialConvInormAct3d``), and SE's mean is
the volume's.
The TPU's NDHCW stage layout has no counterpart: the one NDHWC kernel
computes the same thing.

``DropPath`` (stochastic depth) and ``Dropout`` draw their keep masks from
the train state's generator (``training.train_state``); every block here
is stride 1 (the JAX factories build their strided variants nowhere).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ...ops.activations import Act, gelu, get_act
from ...ops.kernels.conv2d import Conv2dSame
from ...ops.kernels.conv3d import (Conv3dSame, ConvInormAct3d,
                                   SpatialConvInormAct3d)
from ...ops.kernels.fused_norm import (InstanceNormAct,
                                       SpatialInstanceNormAct, supported_act)
from ...parallel import spatial
from ...parallel.collectives import all_reduce_sum

KernelArg = Union[int, Sequence[int]]

#: conv module and channels-last memory format of each spatial rank
CONV = {2: nn.Conv2d, 3: nn.Conv3d}
CHANNELS_LAST = {2: torch.channels_last, 3: torch.channels_last_3d}

#: the batch-statistics momentum of Flax's BatchNorm(momentum=0.9):
#: running = 0.9 * running + 0.1 * batch
BN_MOMENTUM = 0.1


def _tuple(v: KernelArg, n: int) -> tuple:
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(t) for t in v)


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """NC(D)HW (any memory format) -> a contiguous N(D)HWC view."""
    return x.contiguous(memory_format=CHANNELS_LAST[x.dim() - 2]).movedim(1, -1)


def from_channels_last(t: torch.Tensor) -> torch.Tensor:
    """N(D)HWC -> NC(D)HW view in channels-last memory."""
    return t.movedim(-1, 1)


def grouped_conv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """A grouped 3D ``conv`` in contiguous NCDHW memory, weight included.

    With the input or the weight in channels_last_3d memory, cuDNN runs a
    grouped 3D conv one channel group at a time: 10-20x slower at the
    MBConv and B-MHA depthwise shapes on an H100 than the same conv in
    contiguous memory, even counting the two layout copies.  (The JAX
    package sidesteps XLA's grouped conv the same way, ``_DepthwiseTapConv``.)
    ``get_model`` keeps grouped 3D weights contiguous.  Returns
    channels_last_3d memory like the other layers.  Grouped 2D convs stay in
    channels_last: there cuDNN's depthwise path is the faster one at the
    MedFormer-2D shapes (``chip_smoke.py`` phase 3, PERF.md)."""
    y = F.conv3d(x.contiguous(), conv.weight, conv.bias,
                 padding=conv.padding, groups=conv.groups)
    return y.contiguous(memory_format=torch.channels_last_3d)


def spatial_group(module: nn.Module):
    """The process group over whose ranks ``module``'s input is sharded
    along H (``spatial_shard``), in training mode; None otherwise."""
    return getattr(module, "spatial_group", None) if module.training \
        else None


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` of x: a grouped 3D conv through ``grouped_conv``; under a
    spatial group (``spatial_shard``) on the slab and the neighbours'
    halo planes (``parallel.spatial.halo_conv``)."""
    grouped = isinstance(conv, nn.Conv3d) and conv.groups > 1
    group = spatial_group(conv)
    if group is None:
        return grouped_conv(conv, x) if grouped else conv(x)

    def fn(t):
        if grouped:
            return grouped_conv(conv, t)
        return conv._conv_forward(t, conv.weight, conv.bias)
    return spatial.halo_conv(fn, x, conv.kernel_size[-2], group)


def _refuse_direct_call(conv: nn.Module, args) -> None:
    """The forward pre-hook of a marked conv (``spatial_shard``): its
    callers go through ``_conv``, which adds the halo; a direct call would
    pad the slab with zeros where its neighbours' rows belong."""
    if spatial_group(conv) is not None:
        raise RuntimeError("a conv of an H-sharded model was called "
                           "directly: call it through layers.convs._conv")


def spatial_shard(model: nn.Module, group) -> nn.Module:
    """Mark ``model`` as trained on H slabs over the process ``group``
    (the 'spatial' mesh axis, ``parallel.spatial``), in the spirit of
    ``sync_batch_norm``, in place; returns ``model``.

    Every conv and every module with a ``spatial_group`` slot (``Norm``,
    ``ConvNormAct``, ``SEBlock``, the decoders' resizes, MedFormer's
    attention and map generation) takes the group; in training mode they
    then exchange halos (convs whose kernel spans more than one row of H),
    merge statistics over space (InstanceNorm, SE's mean) and resize and
    take softmaxes over the whole H.  A module's ``replicated`` names its
    children that compute on tensors every peer holds whole (MedFormer's
    semantic maps): they stay unmarked.  A model holds the mark in eval
    mode too, where nothing is sharded.  Take copies (the EMA model) before
    marking: a process group does not deep-copy."""
    skip = set()
    for name, m in model.named_modules():
        if any(name == p or name.startswith(p + ".") for p in skip):
            continue
        skip.update(f"{name}.{c}" if name else c
                    for c in getattr(m, "replicated", ()))
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            k, st, pad = m.kernel_size[-2], m.stride[-2], m.padding[-2]
            if st != 1 or pad != k // 2 or k % 2 == 0:
                raise NotImplementedError(
                    f"an H-sharded conv of kernel {k}, stride {st} and "
                    f"padding {pad}: only stride-1 SAME convs exchange a "
                    "halo (ROADMAP A7)")
            m.spatial_group = group
            if k > 1:
                m.register_forward_pre_hook(_refuse_direct_call)
        elif hasattr(m, "spatial_group"):
            m.spatial_group = group
    return model


def _no_generator(name: str) -> RuntimeError:
    return RuntimeError(
        f"{name} draws from the train state's generator: build the state "
        f"with training.train_state.create_train_state")


class DropPath(nn.Module):
    """Batch-wise stochastic depth (``cbim_tpu/models/layers/convs.py``
    ``DropPath``): in training mode with p > 0, ``x / (1 - p) * keep`` with
    keep = u > p, one u ~ U(0, 1) per sample; the identity at p = 0 and in
    eval mode.  u comes from ``generator``, a ``torch.Generator`` on the
    model's device that the train state owns and seeds from the run's seed
    (``training.train_state.create_train_state``); a training-mode call
    with p > 0 and none raises."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0 or not self.training:
            return x
        if self.generator is None:
            raise _no_generator("DropPath")
        u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                       generator=self.generator, device=x.device)
        return drop_path(x, self.p, u > self.p)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def drop_path(x: torch.Tensor, p: float, keep: torch.Tensor) -> torch.Tensor:
    """The JAX package's formula under a given keep mask (bool, one entry a
    sample, broadcast over the rest)."""
    return x / (1.0 - p) * keep


class Dropout(nn.Module):
    """Elementwise dropout (JAX ``nn.Dropout(p)``): in training mode
    ``where(keep, x / (1 - p), 0)`` with keep = u < 1 - p, u ~ U(0, 1) for
    every element, drawn from ``generator`` (the train state's; a
    training-mode call with p > 0 and none raises); the identity in eval
    mode and at p = 0."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None:
            raise _no_generator("Dropout")
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return u < 1.0 - self.p

    def forward(self, x):
        if self.p == 0.0 or not self.training:
            return x
        return torch.where(self.keep_mask(x), x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def global_batch_norm(x: torch.Tensor, weight, bias, eps: float, group):
    """Training-mode BatchNorm over the global batch of a data-parallel
    run, x (B, C, *spatial) this rank's rows: the per-channel sum, sum of
    squares and count cross the ranks in one fp32 ``all_reduce_sum``
    (differentiable), and the biased variance is E[x^2] - E[x]^2 (at least
    0), as Flax's BatchNorm computes it on the JAX mesh, where a mean over
    the sharded batch axis is global.  Returns (y in x's dtype, mean, var),
    the statistics fp32.  ``torch.nn.SyncBatchNorm`` is not used: it
    refuses CPU tensors, and its running variance is the unbiased one."""
    dims = [0, *range(2, x.dim())]
    xf = x.float()
    C = x.shape[1]
    count = torch.full((1,), float(x.numel() // C), device=x.device)
    stats = all_reduce_sum(torch.cat([xf.sum(dims), xf.square().sum(dims),
                                      count]), group)
    mean = stats[:C] / stats[-1]
    var = (stats[C:2 * C] / stats[-1] - mean.square()).clamp_min(0.0)
    shape = (1, C) + (1,) * (x.dim() - 2)
    scale = torch.rsqrt(var + eps)
    if weight is not None:
        scale = scale * weight.float()
    y = (xf - mean.view(shape)) * scale.view(shape)
    if bias is not None:
        y = y + bias.float().view(shape)
    return y.to(x.dtype), mean, var


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Mark every BatchNorm of ``model`` (``Norm("bn")``, VNet's
    ``ContBatchNorm``: each module with a ``sync_group`` slot) with the
    process ``group``: in training mode it then normalises with the global
    batch's statistics, in eval mode as before (running statistics, or
    ContBatchNorm's own batch).  In the spirit of
    ``torch.nn.SyncBatchNorm.convert_sync_batchnorm``, in place; returns
    ``model``.  A marked module does not deep-copy (a process group does
    not): take copies (the EMA model) before marking."""
    for m in model.modules():
        if hasattr(m, "sync_group"):
            m.sync_group = group
    return model


class Norm(nn.Module):
    """Config-selected normalization over x (B, C, *spatial), then ``act``:

    - ``"in"``: parameter-free InstanceNorm (torch's default affine=False,
      biased variance over the spatial axes) on the fused norm kernels,
      with ``act`` fused where they fuse it (none, relu, gelu); any other
      activation runs after them, plain;
    - ``"bn"``: BatchNorm with affine weight/bias and running statistics
      (the reference's ``nn.BatchNorm*d`` names, so ``load_state_dict``
      takes its state_dicts).  It follows Flax's ``BatchNorm(momentum=0.9)``
      rather than torch's: the running variance takes the *biased* batch
      variance, and the statistics stay fp32 under bf16 autocast.  With a
      ``sync_group`` (``sync_batch_norm``) training mode takes the global
      batch's statistics (``global_batch_norm``);
      under H sharding (``spatial_shard``) InstanceNorm takes the whole
      volume's statistics (``SpatialInstanceNormAct``), and BatchNorm's
      group sums cover every slab already;
    - ``"ln"``: LayerNorm over C alone (the reference's channels-first
      LayerNorm; Flax's ``LayerNorm`` over the channels-last axis) with
      affine ``weight``/``bias`` and the caller's eps, computed in fp32
      under autocast as Flax computes its statistics;
    - ``None``/``False``: identity."""

    def __init__(self, kind="in", eps: float = 1e-4, channels: int | None = None):
        super().__init__()
        self.kind = kind
        self.eps = eps
        if kind in ("bn", "ln"):
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        if kind == "bn":
            self.sync_group = None
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))
            self.register_buffer("num_batches_tracked",
                                 torch.tensor(0, dtype=torch.long))
        elif kind not in ("in", "ln", None, False):
            raise ValueError(f"unknown norm {kind!r}")
        #: H-sharded training (``spatial_shard``): InstanceNorm's statistics
        #: are the whole volume's
        self.spatial_group = None

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.sync_group is not None:
            y, mean, var = global_batch_norm(x, self.weight, self.bias,
                                             self.eps, self.sync_group)
            mean, var = mean.detach(), var.detach()
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, BN_MOMENTUM,
                self.eps)
            # the biased variance the batch was normalised with, fp32
            var = invstd.detach().float().pow(-2) - self.eps
        with torch.no_grad():
            self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                mean.float(), alpha=BN_MOMENTUM)
            self.running_var.mul_(1 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
            self.num_batches_tracked += 1
        return y

    def _layer_norm(self, x: torch.Tensor) -> torch.Tensor:
        # channels last: a free view of channels-last memory; at least fp32
        t = x.movedim(1, -1)
        dt = torch.promote_types(t.dtype, torch.float32)
        y = F.layer_norm(t.to(dt), (t.shape[-1],), self.weight.to(dt),
                         self.bias.to(dt), self.eps)
        return y.to(x.dtype).movedim(-1, 1)

    def forward(self, x, act=None):
        if self.kind == "in":
            fuse = supported_act(act)
            fact = act if fuse else None
            group = spatial_group(self)
            if group is None:
                t = InstanceNormAct.apply(to_channels_last(x), self.eps, fact)
            else:
                t = SpatialInstanceNormAct.apply(to_channels_last(x),
                                                 self.eps, fact, group)
            x = from_channels_last(t)
            return x if fuse else get_act(act)(x)
        if self.kind == "bn":
            x = self._batch_norm(x)
        elif self.kind == "ln":
            x = self._layer_norm(x)
        return get_act(act)(x)


class ConvNormAct(nn.Module):
    """conv + norm + act, pre- or post-activated (conv_layers.py:16-53);
    stride 1, padding k // 2.  The reference's dim3 ConvNormAct passes
    eps=1e-4, its dim2 twin torch's default 1e-5 (``cbim_tpu`` convs.py:
    415-417).

    ``conv_na``: compute a preact InstanceNorm 3^3 conv as the fused
    ``ConvInormAct3d`` where it applies (``fused``); the parameters are the
    same either way (the InstanceNorm is affine-free).  ``conv2d_kernel``:
    route an eligible 3x3 conv through ``Conv2dSame`` (``kernel``); the
    route is chosen here, when the module is built."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: KernelArg = 3,
                 groups: int = 1, norm="bn", act="relu", preact: bool = False,
                 nd: int = 3, conv_na: bool = False,
                 conv2d_kernel: bool = False):
        super().__init__()
        k = _tuple(kernel_size, nd)
        self.conv = CONV[nd](in_ch, out_ch, k,
                             padding=tuple(ki // 2 for ki in k),
                             groups=groups, bias=False)
        self.norm = Norm(norm, eps=1e-4 if nd == 3 else 1e-5,
                         channels=in_ch if preact else out_ch)
        self.act = act
        self.preact = preact
        self.kernel = None
        if k == (3,) * nd and groups == 1 and in_ch <= 192:
            if nd == 3 and out_ch <= 128:
                self.kernel = Conv3dSame
            elif nd == 2 and out_ch <= 192 and conv2d_kernel:
                self.kernel = Conv2dSame
        self.fused = (conv_na and preact and norm == "in"
                      and self.kernel is Conv3dSame and supported_act(act))

    def _conv(self, x):
        if self.kernel is None:
            return _conv(self.conv, x)

        def fn(t):
            return from_channels_last(
                self.kernel.apply(to_channels_last(t), self.conv.weight))
        group = spatial_group(self.conv)
        if group is None:
            return fn(x)
        return spatial.halo_conv(fn, x, 3, group)

    def forward(self, x):
        if self.fused:
            group = spatial_group(self.conv)
            if group is not None:
                return from_channels_last(SpatialConvInormAct3d.apply(
                    to_channels_last(x), self.conv.weight, self.norm.eps,
                    self.act, group))
            return from_channels_last(ConvInormAct3d.apply(
                to_channels_last(x), self.conv.weight, self.norm.eps,
                self.act))
        if self.preact:
            return self._conv(self.norm(x, self.act))
        return self.norm(self._conv(x), self.act)


class SingleConv(nn.Module):
    """conv_layers.py:56-68 — one post-activated ConvNormAct (``conv_na``
    passes through; it fuses only preact convs)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, norm="bn", act="relu",
                 nd: int = 3, conv_na: bool = False,
                 conv2d_kernel: bool = False):
        super().__init__()
        self.conv = ConvNormAct(in_ch, out_ch, kernel_size, norm=norm, act=act,
                                nd=nd, conv_na=conv_na,
                                conv2d_kernel=conv2d_kernel)

    def forward(self, x):
        return self.conv(x)


class BasicBlock(nn.Module):
    """conv_layers.py:71-94 — preact residual block (2 convs + shortcut)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, norm="bn", act="relu",
                 nd: int = 3, conv_na: bool = False,
                 conv2d_kernel: bool = False):
        super().__init__()
        kw = dict(norm=norm, act=act, preact=True, nd=nd, conv_na=conv_na,
                  conv2d_kernel=conv2d_kernel)
        self.conv1 = ConvNormAct(in_ch, out_ch, kernel_size, **kw)
        self.conv2 = ConvNormAct(out_ch, out_ch, kernel_size, **kw)
        self.shortcut = (ConvNormAct(in_ch, out_ch, kernel_size, **kw)
                         if in_ch != out_ch else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + (x if self.shortcut is None else self.shortcut(x))


class DepthwiseSeparableConv(nn.Module):
    """conv_layers.py:126-157 — depthwise conv + pointwise conv."""

    def __init__(self, in_ch, out_ch, kernel_size=3, nd: int = 3):
        super().__init__()
        k = _tuple(kernel_size, nd)
        self.depthwise = CONV[nd](in_ch, in_ch, k,
                                  padding=tuple(ki // 2 for ki in k),
                                  groups=in_ch, bias=False)
        self.pointwise = CONV[nd](in_ch, out_ch, 1, bias=False)

    def forward(self, x):
        return self.pointwise(_conv(self.depthwise, x))


class SEBlock(nn.Module):
    """conv_layers.py:159-174 — squeeze-and-excitation, ratio 4."""

    def __init__(self, in_ch, act="relu", nd: int = 3):
        super().__init__()
        self.excitation = nn.Sequential(
            CONV[nd](in_ch, in_ch // 4, 1), Act(act),
            CONV[nd](in_ch // 4, in_ch, 1))
        #: H-sharded training (``spatial_shard``): the mean is the volume's
        self.spatial_group = None

    def forward(self, x):
        dims = tuple(range(2, x.dim()))
        group = spatial_group(self)
        if group is None:
            s = x.mean(dim=dims, keepdim=True)
        else:
            total = all_reduce_sum(
                x.sum(dim=dims, keepdim=True, dtype=torch.float32), group)
            s = (total / (math.prod(x.shape[2:])
                          * dist.get_world_size(group))).to(x.dtype)
        return x * torch.sigmoid(self.excitation(s))


class Bottleneck(nn.Module):
    """conv_layers.py:97-123 — preact 1-k-1 bottleneck, expansion 2:
    ``conv1`` (1^d, to out/2), ``conv2`` (k, out/2), ``conv3`` (1^d, to
    out), each norm + act + conv, and a k-kernel ``shortcut`` ConvNormAct
    where the width changes (the reference's names).  ``conv_na`` and
    ``conv2d_kernel`` pass through as for BasicBlock: ``conv2`` and the
    shortcut take the 3^3 or 3x3 kernel route where ConvNormAct gives it."""

    def __init__(self, in_ch, out_ch, kernel_size=3, norm="bn", act="relu",
                 nd: int = 3, conv_na: bool = False,
                 conv2d_kernel: bool = False):
        super().__init__()
        mid = out_ch // 2
        kw = dict(norm=norm, act=act, preact=True, nd=nd, conv_na=conv_na,
                  conv2d_kernel=conv2d_kernel)
        self.conv1 = ConvNormAct(in_ch, mid, 1, **kw)
        self.conv2 = ConvNormAct(mid, mid, kernel_size, **kw)
        self.conv3 = ConvNormAct(mid, out_ch, 1, **kw)
        self.shortcut = (ConvNormAct(in_ch, out_ch, kernel_size, **kw)
                         if in_ch != out_ch else None)

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        return out + (x if self.shortcut is None else self.shortcut(x))


def _se_name(nd: int) -> str:
    """The SE module's name: the dim2 reference calls it ``se_block``, the
    dim3 one ``se``."""
    return "se_block" if nd == 2 else "se"


class MBConv(nn.Module):
    """conv_layers.py:197-238 — inverted residual: 1^d ``expand_proj`` to
    ``expansion`` x in (where expansion != 1), depthwise k conv
    (``depthwise``), SE (``se``, ``se_block`` in 2D), 1^d ``pointwise``
    without act, stochastic depth of rate ``p`` (``drop_path``), and a
    norm-free k-kernel ``shortcut`` where the width changes.  ``conv_na``
    passes through (none of its convs is a fused one: 1x1, grouped, or
    without a norm), and so does ``conv2d_kernel`` (the 3x3 shortcut may
    take it)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, norm="bn", act="relu",
                 nd: int = 3, conv_na: bool = False,
                 conv2d_kernel: bool = False, expansion: int = 4,
                 p: float = 0.0):
        super().__init__()
        expanded = expansion * in_ch
        kw = dict(norm=norm, nd=nd, conv_na=conv_na,
                  conv2d_kernel=conv2d_kernel)
        self.expand_proj = (
            ConvNormAct(in_ch, expanded, 1, act=act, preact=True, **kw)
            if expansion != 1 else None)
        self.depthwise = ConvNormAct(expanded, expanded, kernel_size,
                                     groups=expanded, act=act, preact=True,
                                     **kw)
        self.se_name = _se_name(nd)
        self.add_module(self.se_name, SEBlock(expanded, act=act, nd=nd))
        self.pointwise = ConvNormAct(expanded, out_ch, 1, act=False,
                                     preact=True, **kw)
        self.drop_path = DropPath(p)
        self.shortcut = (ConvNormAct(in_ch, out_ch, kernel_size, act=False,
                                     **dict(kw, norm=False))
                         if in_ch != out_ch else None)

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        if self.expand_proj is not None:
            x = self.expand_proj(x)
        se = getattr(self, self.se_name)
        return self.drop_path(self.pointwise(se(self.depthwise(x)))) \
            + residual


class FusedMBConv(nn.Module):
    """conv_layers.py:241-281 — fused inverted residual: a dense k-kernel
    expansion to ``expansion`` x in (``conv3x3``, norm + act + conv, the
    name whatever k is), SE (``se``, ``se_block`` in 2D), a 1^d
    ``pointwise`` without act, stochastic depth of rate ``p``
    (``drop_path``), and a norm-free k-kernel ``shortcut`` where the width
    changes.  The expansion conv is a ConvNormAct like any other: with
    InstanceNorm at a 3^3 kernel inside the route's widths it takes the 3^3
    conv kernel (and the fused pair with ``conv_na``)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, norm="bn", act="relu",
                 nd: int = 3, conv_na: bool = False,
                 conv2d_kernel: bool = False, expansion: int = 4,
                 p: float = 0.0):
        super().__init__()
        expanded = expansion * in_ch
        kw = dict(norm=norm, nd=nd, conv_na=conv_na,
                  conv2d_kernel=conv2d_kernel)
        self.conv3x3 = ConvNormAct(in_ch, expanded, kernel_size, act=act,
                                   preact=True, **kw)
        self.se_name = _se_name(nd)
        self.add_module(self.se_name, SEBlock(expanded, act=act, nd=nd))
        self.pointwise = ConvNormAct(expanded, out_ch, 1, act=False,
                                     preact=True, **kw)
        self.drop_path = DropPath(p)
        self.shortcut = (ConvNormAct(in_ch, out_ch, kernel_size, act=False,
                                     **dict(kw, norm=False))
                         if in_ch != out_ch else None)

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        se = getattr(self, self.se_name)
        return self.drop_path(self.pointwise(se(self.conv3x3(x)))) + residual


class ConvNeXtBlock(nn.Module):
    """model/dim2/conv_layers.py:274+ (JAX ``ConvNeXtBlock``): a k^d
    depthwise conv with bias (``dwconv``; 3D through ``grouped_conv``),
    LayerNorm over C at eps 1e-6 (``norm``), Linear to 4 x in
    (``pwconv1``), exact GELU, Linear to out (``pwconv2``), the layer scale
    (``gamma``, initialised to ``layer_scale_init_value``; none at 0),
    stochastic depth (``drop_path``), and the residual where in == out.
    The names are the official ConvNeXt's.

    It takes no norm and no act.  Both JAX factories pass ``norm=`` and
    ``act=`` to every block and so cannot build it (a TypeError); the
    port's factories fail on it the same way, with this reason."""

    def __init__(self, in_ch, out_ch, kernel_size=7, drop_path: float = 0.0,
                 layer_scale_init_value: float = 1e-6, nd: int = 3,
                 **factory_kw):
        super().__init__()
        if factory_kw:
            raise TypeError(
                f"ConvNeXtBlock takes no {', '.join(sorted(factory_kw))}: "
                f"it has its own LayerNorm and GELU, so the model factories, "
                f"which pass norm= and act= to every block, cannot build it "
                f"(the JAX package's fail the same way)")
        k = _tuple(kernel_size, nd)
        self.dwconv = CONV[nd](in_ch, in_ch, k,
                               padding=tuple(ki // 2 for ki in k),
                               groups=in_ch)
        self.norm = nn.LayerNorm(in_ch, eps=1e-6)
        self.pwconv1 = nn.Linear(in_ch, 4 * in_ch)
        self.pwconv2 = nn.Linear(4 * in_ch, out_ch)
        self.gamma = (nn.Parameter(torch.full((out_ch,),
                                              float(layer_scale_init_value)))
                      if layer_scale_init_value > 0 else None)
        self.drop_path = DropPath(drop_path)
        self.residual = in_ch == out_ch

    def forward(self, x):
        # channels last: a free view of channels-last memory
        t = _conv(self.dwconv, x).movedim(1, -1)
        t = self.pwconv2(gelu(self.pwconv1(self.norm(t))))
        if self.gamma is not None:
            t = t * self.gamma
        y = self.drop_path(t.movedim(-1, 1))
        return y + x if self.residual else y


#: the reference's get_block (model/dim3/utils.py:7-13) by config string,
#: with the JAX package's whole table
BLOCKS = {"SingleConv": SingleConv, "ConvNormAct": SingleConv,
          "BasicBlock": BasicBlock, "Bottleneck": Bottleneck,
          "MBConv": MBConv, "FusedMBConv": FusedMBConv,
          "ConvNeXtBlock": ConvNeXtBlock}


def get_block_cls(name: str):
    """The block class of a config string (KeyError for another, as in
    JAX)."""
    return BLOCKS[name]
