"""Stride-1 SAME 3^3 convolution forward: CUDA kernel and plain version.

Port of the forward of ``cbim_tpu/ops/pallas/conv3d.py`` (``conv3d_same``
and its NDHCW twins ``conv3d_same_cw``/``conv3d_same_cw2``, which compute
the same thing in another layout).  One kernel, ``conv3d_same_fwd`` in
``csrc/conv3d.cu``: x[B, D, H, W, C] (x) w[F, C, 3, 3, 3] -> y[B, D, H, W, F]
with fp32 sums, any D/H/W (the kernel masks its own edges).

The weight takes torch's layout; the wrapper packs it to [3, 3, 3, C, F]
(a copy of 27*C*F values) so the kernel reads rows of output channels.
CPU tensors take the plain version, ``F.conv3d`` with padding 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _backend
from . import _build

#: launches of the kernel since the last reset (plain calls do not count)
launches = {"conv3d_same_fwd": 0}


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"expected x[B, D, H, W, C], got {tuple(x.shape)}")
    C = x.shape[-1]
    if w.dim() != 5 or tuple(w.shape[1:]) != (C, 3, 3, 3):
        raise ValueError(f"expected w[F, {C}, 3, 3, 3], got {tuple(w.shape)}")
    _backend.dtype_code(x)
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError("x and w must share dtype and device")


def conv3d_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv3d`` with padding 1, channels-last in and out."""
    _check(x, w)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv3d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1, zero-pad-1 3^3 correlation: x[B, D, H, W, C] with torch
    weights w[F, C, 3, 3, 3] -> y[B, D, H, W, F] in x.dtype.

    The counterpart of ``cbim_tpu.ops.pallas.conv3d.conv3d_same`` (which
    takes w as [3, 3, 3, C, F]).  CUDA tensors launch the kernel, CPU
    tensors run the plain version."""
    _check(x, w)
    if not _backend.uses_kernels(x):
        return conv3d_same_plain(x, w)
    if not x.is_contiguous():
        raise ValueError("kernel needs a contiguous x[B, D, H, W, C]")
    B, D, H, W, C = x.shape
    Fo = w.shape[0]
    wp = w.permute(2, 3, 4, 1, 0).contiguous()
    y = torch.empty((B, D, H, W, Fo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _build.call("conv3d_same_fwd", x.data_ptr(), wp.data_ptr(),
                    y.data_ptr(), _backend.dtype_code(x), B, D, H, W, C, Fo,
                    torch.cuda.current_stream().cuda_stream)
    launches["conv3d_same_fwd"] += 1
    return y
