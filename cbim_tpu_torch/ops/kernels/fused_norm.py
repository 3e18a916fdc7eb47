"""Fused InstanceNorm(+activation) forward: CUDA kernels and plain version.

Port of the forward of ``cbim_tpu/ops/pallas/fused_norm.py``
(``instance_norm_act`` -> ``_compute_stats`` + ``_forward``).  Two kernels,
``csrc/fused_norm.cu``:

- ``inorm_stats``: per-(b, c) mean and rstd over the S rows of x[B, S, C]
  (fp64 partial sums per chunk of rows, folded in a fixed order);
- ``inorm_apply``: y = act((x - mean) * rstd), act in {none, relu, gelu},
  output in x.dtype.

Both run for CUDA tensors; the plain PyTorch versions beside them (two-pass
fp32 mean/variance, the activation in fp32, one cast) run for CPU tensors.
Unlike the TPU gate (``fused_norm.usable``: lane-dense C only), the kernels
take every C: the C % 128 rule was a TPU lane-padding artifact.
"""

from __future__ import annotations

import math

import torch

from .. import _backend
from ..activations import get_act
from . import _build

#: launches of each kernel since the last reset (plain calls do not count)
launches = {"inorm_stats": 0, "inorm_apply": 0}

_ACT_CODES = {None: 0, False: 0, "none": 0, "relu": 1, "gelu": 2}

#: blocks the stats pass aims for (a few waves over 132 SMs)
_TARGET_BLOCKS = 2048
_MIN_ROWS_PER_CHUNK = 256


def _act_code(act) -> int:
    if act not in _ACT_CODES:
        raise ValueError(f"fused_norm: unsupported act {act!r}")
    return _ACT_CODES[act]


def _check_rows(x3: torch.Tensor) -> None:
    if x3.dim() != 3:
        raise ValueError(f"expected x[B, S, C], got shape {tuple(x3.shape)}")
    _backend.dtype_code(x3)


def _check_cuda(x3: torch.Tensor) -> None:
    _check_rows(x3)
    if x3.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x3.device}")
    if not x3.is_contiguous():
        raise ValueError("kernel needs a contiguous x[B, S, C]")


def _chunking(B: int, S: int, C: int) -> tuple[int, int]:
    """(rows_per_chunk, n_chunks) for the split reduction over S."""
    c_tiles = -(-C // 32)
    want = max(1, _TARGET_BLOCKS // (B * c_tiles))
    n_chunks = max(1, min(want, S // _MIN_ROWS_PER_CHUNK, 65535))
    rows = -(-S // n_chunks)
    return rows, -(-S // rows)


def inorm_stats(x3: torch.Tensor, eps: float):
    """Kernel: x3[B, S, C] -> (mean, rstd), each float32 [B, C]."""
    _check_cuda(x3)
    B, S, C = x3.shape
    rows, n_chunks = _chunking(B, S, C)
    partial = torch.empty(B * n_chunks * 2 * C, dtype=torch.float64,
                          device=x3.device)
    mean = torch.empty(B, C, dtype=torch.float32, device=x3.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x3.device):
        _build.call("inorm_stats", x3.data_ptr(), _backend.dtype_code(x3),
                    B, S, C, rows, n_chunks, float(eps), partial.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
    launches["inorm_stats"] += 1
    return mean, rstd


def inorm_stats_plain(x3: torch.Tensor, eps: float):
    """Plain version of :func:`inorm_stats`: two-pass fp32 biased variance."""
    _check_rows(x3)
    x32 = x3.float()
    mean = x32.mean(dim=1)
    var = (x32 - mean[:, None]).square().mean(dim=1)
    return mean, torch.rsqrt(var + eps)


def inorm_apply(x3: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                act=None) -> torch.Tensor:
    """Kernel: y = act((x3 - mean) * rstd) in x3.dtype."""
    _check_cuda(x3)
    B, S, C = x3.shape
    for t in (mean, rstd):
        if (t.shape != (B, C) or t.dtype != torch.float32
                or t.device != x3.device or not t.is_contiguous()):
            raise ValueError("mean/rstd must be contiguous float32 [B, C] "
                             "on x's device")
    code = _act_code(act)
    y = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        _build.call("inorm_apply", x3.data_ptr(), y.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), _backend.dtype_code(x3),
                    code, B, S, C, torch.cuda.current_stream().cuda_stream)
    launches["inorm_apply"] += 1
    return y


def inorm_apply_plain(x3: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor, act=None) -> torch.Tensor:
    """Plain version of :func:`inorm_apply` (act in fp32, one cast)."""
    _check_rows(x3)
    _act_code(act)
    n = (x3.float() - mean[:, None]) * rstd[:, None]
    return get_act(act)(n).to(x3.dtype)


def instance_norm_act_plain(x: torch.Tensor, eps: float = 1e-4,
                            act=None) -> torch.Tensor:
    x3 = x.reshape(x.shape[0], -1, x.shape[-1])
    mean, rstd = inorm_stats_plain(x3, eps)
    return inorm_apply_plain(x3, mean, rstd, act).reshape(x.shape)


def instance_norm_act(x: torch.Tensor, eps: float = 1e-4,
                      act=None) -> torch.Tensor:
    """InstanceNorm (affine-free, biased variance over the spatial axes)
    followed by ``act``, over a channels-last x (B, *spatial, C).

    The counterpart of ``cbim_tpu.ops.pallas.fused_norm.instance_norm_act``.
    CUDA tensors go through the two kernels, CPU tensors through the plain
    version."""
    if x.dim() < 3:
        raise ValueError(f"expected (B, *spatial, C), got {tuple(x.shape)}")
    _act_code(act)
    if not _backend.uses_kernels(x):
        return instance_norm_act_plain(x, eps, act)
    if not x.is_contiguous():
        raise ValueError("kernel needs a contiguous channels-last x")
    B, C = x.shape[0], x.shape[-1]
    x3 = x.view(B, math.prod(x.shape[1:-1]), C)
    mean, rstd = inorm_stats(x3, eps)
    return inorm_apply(x3, mean, rstd, act).view(x.shape)
