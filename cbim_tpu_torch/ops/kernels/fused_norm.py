"""Fused InstanceNorm(+activation), forward and backward: CUDA kernels,
their plain versions, and the ``torch.autograd.Function`` that trains
through them.

Port of ``cbim_tpu/ops/pallas/fused_norm.py`` (``instance_norm_act`` ->
``_compute_stats`` + ``_forward``, and the custom VJP's ``_backward``).
Four kernels, ``csrc/fused_norm.cu``:

- ``inorm_stats``: per-(b, c) mean and rstd over the S rows of x[B, S, C]
  (fp64 partial sums per chunk of rows, folded in a fixed order);
- ``inorm_apply``: y = act((x - mean) * rstd), act in {none, relu, gelu},
  output in x.dtype;
- ``inorm_bwd_stats``: per-(b, c) a = mean(dy') and b = mean(dy' * x_hat),
  with x_hat = (x - mean) * rstd and dy' = dy * act'(x_hat) (the same split
  reduction as ``inorm_stats``);
- ``inorm_bwd_apply``: dx = rstd * (dy' - a - x_hat * b) in x.dtype.

All run for CUDA tensors; the plain PyTorch versions beside them (fp32
math, one cast) run for CPU tensors.  Unlike the TPU gate
(``fused_norm.usable``: lane-dense C only), the kernels take every C: the
C % 128 rule was a TPU lane-padding artifact.
"""

from __future__ import annotations

import math

import torch

from .. import _backend
from ..activations import gelu_grad, get_act
from . import _build

#: launches of each kernel since the last reset (plain calls do not count)
launches = {"inorm_stats": 0, "inorm_apply": 0, "inorm_bwd_stats": 0,
            "inorm_bwd_apply": 0}

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
    _check_stats(x3, mean, rstd)
    B, S, C = x3.shape
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


def _check_stats(x3: torch.Tensor, *stats: torch.Tensor) -> None:
    B, _, C = x3.shape
    for t in stats:
        if (t.shape != (B, C) or t.dtype != torch.float32
                or t.device != x3.device or not t.is_contiguous()):
            raise ValueError("mean/rstd must be contiguous float32 [B, C] "
                             "on x's device")


def _check_dy(x3: torch.Tensor, dy3: torch.Tensor) -> None:
    if dy3.shape != x3.shape or dy3.dtype != x3.dtype \
            or dy3.device != x3.device or not dy3.is_contiguous():
        raise ValueError("dy must be contiguous, of x's shape, dtype and "
                         "device")


def _act_grad(act):
    """d act(n) / dn, from the pre-activation n (fp32)."""
    if act in (None, False, "none"):
        return torch.ones_like
    if act == "relu":
        return lambda n: (n > 0).to(n.dtype)
    return gelu_grad


def inorm_bwd_stats(x3: torch.Tensor, dy3: torch.Tensor, mean: torch.Tensor,
                    rstd: torch.Tensor, act=None) -> torch.Tensor:
    """Kernel: red[B, 2, C] float32, red[:, 0] = mean(dy'), red[:, 1] =
    mean(dy' * x_hat) over the S rows."""
    _check_cuda(x3)
    _check_dy(x3, dy3)
    _check_stats(x3, mean, rstd)
    code = _act_code(act)
    B, S, C = x3.shape
    rows, n_chunks = _chunking(B, S, C)
    partial = torch.empty(B * n_chunks * 2 * C, dtype=torch.float64,
                          device=x3.device)
    red = torch.empty(B, 2, C, dtype=torch.float32, device=x3.device)
    with torch.cuda.device(x3.device):
        _build.call("inorm_bwd_stats", x3.data_ptr(), dy3.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), _backend.dtype_code(x3),
                    code, B, S, C, rows, n_chunks, partial.data_ptr(),
                    red.data_ptr(), torch.cuda.current_stream().cuda_stream)
    launches["inorm_bwd_stats"] += 1
    return red


def inorm_bwd_stats_plain(x3: torch.Tensor, dy3: torch.Tensor,
                          mean: torch.Tensor, rstd: torch.Tensor,
                          act=None) -> torch.Tensor:
    """Plain version of :func:`inorm_bwd_stats` (fp32)."""
    _check_rows(x3)
    _act_code(act)
    xhat = (x3.float() - mean[:, None]) * rstd[:, None]
    dyp = dy3.float() * _act_grad(act)(xhat)
    return torch.stack([dyp.mean(dim=1), (dyp * xhat).mean(dim=1)], dim=1)


def inorm_bwd_apply(x3: torch.Tensor, dy3: torch.Tensor, mean: torch.Tensor,
                    rstd: torch.Tensor, red: torch.Tensor,
                    act=None) -> torch.Tensor:
    """Kernel: dx = rstd * (dy' - red[:, 0] - x_hat * red[:, 1]) in x3's
    dtype."""
    _check_cuda(x3)
    _check_dy(x3, dy3)
    _check_stats(x3, mean, rstd)
    B, S, C = x3.shape
    if (red.shape != (B, 2, C) or red.dtype != torch.float32
            or red.device != x3.device or not red.is_contiguous()):
        raise ValueError("red must be a contiguous float32 [B, 2, C] on x's "
                         "device")
    code = _act_code(act)
    dx = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        _build.call("inorm_bwd_apply", x3.data_ptr(), dy3.data_ptr(),
                    dx.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                    red.data_ptr(), _backend.dtype_code(x3), code, B, S, C,
                    torch.cuda.current_stream().cuda_stream)
    launches["inorm_bwd_apply"] += 1
    return dx


def inorm_bwd_apply_plain(x3: torch.Tensor, dy3: torch.Tensor,
                          mean: torch.Tensor, rstd: torch.Tensor,
                          red: torch.Tensor, act=None) -> torch.Tensor:
    """Plain version of :func:`inorm_bwd_apply` (fp32, one cast)."""
    _check_rows(x3)
    _act_code(act)
    xhat = (x3.float() - mean[:, None]) * rstd[:, None]
    dyp = dy3.float() * _act_grad(act)(xhat)
    dx = rstd[:, None] * (dyp - red[:, 0:1] - xhat * red[:, 1:2])
    return dx.to(x3.dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Channels-last x (B, *spatial, C) as x3[B, S, C]; the kernels need it
    contiguous."""
    if x.dim() < 3:
        raise ValueError(f"expected (B, *spatial, C), got {tuple(x.shape)}")
    if _backend.uses_kernels(x) and not x.is_contiguous():
        raise ValueError("kernel needs a contiguous channels-last x")
    return x.reshape(x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1])


class InstanceNormAct(torch.autograd.Function):
    """Trainable :func:`instance_norm_act` (the counterpart of
    ``_instance_norm_act3``'s custom VJP): ``InstanceNormAct.apply(x, eps,
    act)`` over a channels-last x (B, *spatial, C).

    Forward: ``inorm_stats`` + ``inorm_apply``, saving x, mean and rstd (as
    ``_inorm_fwd``).  Backward: ``inorm_bwd_stats`` + ``inorm_bwd_apply``;
    eps and act take no gradient.  Under CUDA autocast, x is cast to bf16.
    CPU tensors run the plain versions of all four.  Pure, so safe to
    recompute under activation checkpointing."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, eps, act):
        _act_code(act)
        x3 = _rows(x)
        if _backend.uses_kernels(x3):
            mean, rstd = inorm_stats(x3, eps)
            y = inorm_apply(x3, mean, rstd, act)
        else:
            mean, rstd = inorm_stats_plain(x3, eps)
            y = inorm_apply_plain(x3, mean, rstd, act)
        ctx.save_for_backward(x3, mean, rstd)
        ctx.act = act
        return y.view(x.shape)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x3, mean, rstd = ctx.saved_tensors
        dy3 = dy.to(x3.dtype).contiguous().view(x3.shape)
        if _backend.uses_kernels(x3):
            red = inorm_bwd_stats(x3, dy3, mean, rstd, ctx.act)
            dx = inorm_bwd_apply(x3, dy3, mean, rstd, red, ctx.act)
        else:
            red = inorm_bwd_stats_plain(x3, dy3, mean, rstd, ctx.act)
            dx = inorm_bwd_apply_plain(x3, dy3, mean, rstd, red, ctx.act)
        return dx.view(dy.shape), None, None


def instance_norm_act(x: torch.Tensor, eps: float = 1e-4,
                      act=None) -> torch.Tensor:
    """InstanceNorm (affine-free, biased variance over the spatial axes)
    followed by ``act``, over a channels-last x (B, *spatial, C).

    The counterpart of ``cbim_tpu.ops.pallas.fused_norm.instance_norm_act``.
    CUDA tensors go through the kernels, CPU tensors through the plain
    versions; both train through :class:`InstanceNormAct`."""
    return InstanceNormAct.apply(x, eps, act)
