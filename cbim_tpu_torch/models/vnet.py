"""V-Net (counterpart of ``cbim_tpu/models/vnet.py``; the reference's
model/dim3/vnet.py, after mattmacy/vnet.pytorch): 5^3 convs, ELU (or
per-channel PReLU), strided-conv downsampling, transposed-conv
upsampling, the input transition's channel-repeat residual, and
``ContBatchNorm``.

Parameter names are the reference's (``in_tr``, ``down_tr{32,64,128,256}``,
``up_tr{256,128,64,32}``, ``out_tr``; ``conv1``/``bn1``/``relu1``,
``down_conv``, ``up_conv``, ``ops.{k}``), as
``cbim_tpu.utils.torch_import.import_vnet`` reads them.

- ``ContBatchNorm`` normalises with the batch's statistics in every mode,
  eval included (vnet.py:22-32), and keeps no running buffers: a reference
  state_dict's ``running_*``/``num_batches_tracked`` are dropped on load.
  So a forward's output depends on its whole batch, and the sliding-window
  engine groups windows as the JAX engine does (``batch_statistics``).
- ``ChannelDropout`` is ``nn.Dropout3d``'s whole-channel dropout (p = 0.5,
  training mode only): the deep transitions' ``do1`` and every up
  transition's ``do2`` on the skip.  It draws from the train state's
  generator, as ``DropPath`` does.

VNet reaches no Pallas kernel in JAX; its convs are cuDNN's here, as XLA
carried them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers.convs import global_batch_norm

#: ContBatchNorm's eps and the dropout rate of the reference
BN_EPS = 1e-5
DROP_RATE = 0.5
#: the buffers of the reference's ContBatchNorm (a BatchNorm3d) that the
#: forward never reads
UNUSED_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


class ContBatchNorm(nn.Module):
    """BatchNorm with batch statistics in every mode and a learned affine
    (``weight``, ``bias``), biased variance, eps 1e-5.  With a
    ``sync_group`` (``layers.convs.sync_batch_norm``) training mode takes
    the global batch's statistics; eval mode normalises this rank's batch,
    as the JAX package's ``shard_map`` sweep does."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.sync_group = None

    def forward(self, x):
        if self.training and self.sync_group is not None:
            return global_batch_norm(x, self.weight, self.bias, BN_EPS,
                                     self.sync_group)[0]
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            BN_EPS)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in UNUSED_BN_BUFFERS:
            state_dict.pop(prefix + name, None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class ChannelDropout(nn.Module):
    """Whole-channel dropout (JAX: ``nn.Dropout(p, broadcast_dims=(1, 2,
    3))``): in training mode ``where(keep, x / (1 - p), 0)`` with keep = u
    < 1 - p, one u ~ U(0, 1) per (sample, channel), drawn from
    ``generator`` (the train state's; a training-mode call without one
    raises); the identity in eval mode."""

    def __init__(self, p: float = DROP_RATE):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None:
            raise RuntimeError(
                "ChannelDropout draws from the train state's generator: "
                "build the state with training.train_state."
                "create_train_state")
        u = torch.rand(x.shape[:2] + (1,) * (x.dim() - 2),
                       generator=self.generator, device=x.device)
        return u < 1.0 - self.p

    def forward(self, x):
        if self.p == 0.0 or not self.training:
            return x
        return torch.where(self.keep_mask(x), x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def _act(elu: bool, channels: int) -> nn.Module:
    """ELU, or a per-channel PReLU (weight 0.25) without it."""
    return nn.ELU() if elu else nn.PReLU(channels)


def _conv5(in_ch, out_ch):
    return nn.Conv3d(in_ch, out_ch, 5, padding=2)


class LUConv(nn.Module):
    def __init__(self, channels: int, elu: bool):
        super().__init__()
        self.conv1 = _conv5(channels, channels)
        self.bn1 = ContBatchNorm(channels)
        self.relu1 = _act(elu, channels)

    def forward(self, x):
        return self.relu1(self.bn1(self.conv1(x)))


def _n_conv(channels, n, elu):
    return nn.Sequential(*(LUConv(channels, elu) for _ in range(n)))


class InputTransition(nn.Module):
    """act(bn(conv(x)) + x repeated out_ch // in_ch times on channels)."""

    def __init__(self, in_ch: int, out_ch: int, elu: bool):
        super().__init__()
        self.conv1 = _conv5(in_ch, out_ch)
        self.bn1 = ContBatchNorm(out_ch)
        self.relu1 = _act(elu, out_ch)
        self.reps = out_ch // in_ch

    def forward(self, x):
        out = self.bn1(self.conv1(x))
        return self.relu1(out + x.repeat(1, self.reps, 1, 1, 1))


class DownTransition(nn.Module):
    """A strided conv doubling the channels, then ``n_convs`` LUConvs with a
    residual; whole-channel dropout after the downsampling where
    ``dropout``."""

    def __init__(self, in_ch: int, n_convs: int, elu: bool,
                 dropout: bool = False):
        super().__init__()
        out_ch = 2 * in_ch
        self.down_conv = nn.Conv3d(in_ch, out_ch, 2, stride=2)
        self.bn1 = ContBatchNorm(out_ch)
        self.relu1 = _act(elu, out_ch)
        self.do1 = ChannelDropout() if dropout else None
        self.ops = _n_conv(out_ch, n_convs, elu)
        self.relu2 = _act(elu, out_ch)

    def forward(self, x):
        down = self.relu1(self.bn1(self.down_conv(x)))
        out = down if self.do1 is None else self.do1(down)
        return self.relu2(self.ops(out) + down)


class UpTransition(nn.Module):
    """A transposed conv to out_ch // 2, concatenated with the skip
    (always channel-dropped in training), then ``n_convs`` LUConvs with a
    residual; the input channel-dropped too where ``dropout``."""

    def __init__(self, in_ch: int, out_ch: int, n_convs: int, elu: bool,
                 dropout: bool = False):
        super().__init__()
        self.up_conv = nn.ConvTranspose3d(in_ch, out_ch // 2, 2, stride=2)
        self.bn1 = ContBatchNorm(out_ch // 2)
        self.do1 = ChannelDropout() if dropout else None
        self.do2 = ChannelDropout()
        self.relu1 = _act(elu, out_ch // 2)
        self.relu2 = _act(elu, out_ch)
        self.ops = _n_conv(out_ch, n_convs, elu)

    def forward(self, x, skip):
        out = x if self.do1 is None else self.do1(x)
        skip = self.do2(skip)
        out = self.relu1(self.bn1(self.up_conv(out)))
        xcat = torch.cat([out, skip], dim=1)
        return self.relu2(self.ops(xcat) + xcat)


class OutputTransition(nn.Module):
    def __init__(self, in_ch: int, num_classes: int, elu: bool):
        super().__init__()
        self.conv1 = _conv5(in_ch, num_classes)
        self.bn1 = ContBatchNorm(num_classes)
        self.relu1 = _act(elu, num_classes)
        self.conv2 = nn.Conv3d(num_classes, num_classes, 1)

    def forward(self, x):
        return self.conv2(self.relu1(self.bn1(self.conv1(x))))


class VNet(nn.Module):
    """The reference's model/dim3/vnet.py: base_ch at the input transition
    (16 in the reference), doubled by each of four downsamplings by 2 (the
    JAX factory's scales)."""

    #: the forward normalises with its batch's statistics in eval mode too
    batch_statistics = True

    def __init__(self, in_chan: int, num_classes: int, base_ch: int = 16,
                 elu: bool = True):
        super().__init__()
        c = base_ch
        self.in_tr = InputTransition(in_chan, c, elu)
        self.down_tr32 = DownTransition(c, 1, elu)
        self.down_tr64 = DownTransition(2 * c, 2, elu)
        self.down_tr128 = DownTransition(4 * c, 3, elu, dropout=True)
        self.down_tr256 = DownTransition(8 * c, 2, elu, dropout=True)
        self.up_tr256 = UpTransition(16 * c, 16 * c, 2, elu, dropout=True)
        self.up_tr128 = UpTransition(16 * c, 8 * c, 2, elu, dropout=True)
        self.up_tr64 = UpTransition(8 * c, 4 * c, 1, elu)
        self.up_tr32 = UpTransition(4 * c, 2 * c, 1, elu)
        self.out_tr = OutputTransition(2 * c, num_classes, elu)

    def forward(self, x):
        out16 = self.in_tr(x)
        out32 = self.down_tr32(out16)
        out64 = self.down_tr64(out32)
        out128 = self.down_tr128(out64)
        out = self.down_tr256(out128)
        out = self.up_tr256(out, out128)
        out = self.up_tr128(out, out64)
        out = self.up_tr64(out, out32)
        out = self.up_tr32(out, out16)
        return self.out_tr(out)
