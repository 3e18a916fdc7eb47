"""Stride-1 SAME 3^3 convolution, forward and backward: CUDA kernels, their
plain versions, and the ``torch.autograd.Function`` that trains through them.

Port of ``cbim_tpu/ops/pallas/conv3d.py``: ``conv3d_same`` (and its NDHCW
twins ``conv3d_same_cw``/``conv3d_same_cw2``, which compute the same thing
in another layout), the custom VJP ``conv3d_same_t``, and ``conv3d_wgrad``
(and ``_cw``/``_cw2``).  Two kernels, in ``csrc/conv3d.cu`` and
``csrc/conv3d_wgrad.cu``:

- ``conv3d_same_fwd``: x[B, D, H, W, C] (x) w[F, C, 3, 3, 3] ->
  y[B, D, H, W, F] with fp32 sums, any D/H/W (the kernel masks its own
  edges).  It also computes the input gradient: the SAME correlation of the
  upstream gradient with flip-swapped weights (``_flip_swap``).  Those
  launches count under ``conv3d_dgrad``.
- ``conv3d_wgrad``: dW[3, 3, 3, C, F] = sum over voxels of shifted x times
  g, a split-K reduction with fp32 partials per chunk of voxels, folded in a
  fixed order (no atomics).

The fused preact conv, conv(act(InstanceNorm(x))), is the port of
``conv3d_same_cw_na``, ``conv3d_wgrad_cw2_na`` and ``_cw_stats`` and of their
custom VJP ``conv_inorm_act_cw_t``: the same two kernels with a norm-act
prologue on their staged input rows, ``conv3d_same_na_fwd`` and
``conv3d_wgrad_na``, so the normalised tensor never exists in device memory.
The statistics are ``fused_norm.inorm_stats`` (``_cw_stats`` computes the
same per-(b, c) mean and rstd in the TPU layout).  :class:`ConvInormAct3d`
trains through them.

The weight takes torch's layout; the forward wrapper packs it to
[3, 3, 3, C, F] (a copy of 27*C*F values) so the kernel reads rows of output
channels, and the wgrad wrapper gives back torch's [F, C, 3, 3, 3].
CPU tensors take the plain versions: ``F.conv3d`` with padding 1 and
``torch.nn.grad.conv3d_weight`` (on ``inorm_apply_plain``'s output for the
fused pair).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _backend
from . import _build, fused_norm

#: launches of each kernel since the last reset (plain calls do not count);
#: ``conv3d_dgrad`` counts the forward kernel's input-gradient launches
launches = {"conv3d_same_fwd": 0, "conv3d_dgrad": 0, "conv3d_wgrad": 0,
            "conv3d_same_na_fwd": 0, "conv3d_wgrad_na": 0}

#: blocks a wgrad pass aims for (several waves over 132 SMs), the fewest
#: pixels or voxels a chunk takes, and the most bytes its fp32 partials may
#: take (both wgrad kernels, 3^3 and 3x3)
_WGRAD_TARGET_BLOCKS = 2048
_WGRAD_MIN_ROWS = 512
_WGRAD_MAX_PARTIAL_BYTES = 256 << 20


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"expected x[B, D, H, W, C], got {tuple(x.shape)}")
    C = x.shape[-1]
    if w.dim() != 5 or tuple(w.shape[1:]) != (C, 3, 3, 3):
        raise ValueError(f"expected w[F, {C}, 3, 3, 3], got {tuple(w.shape)}")
    _backend.dtype_code(x)
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError("x and w must share dtype and device")


def _check_wgrad(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 5 or g.dim() != 5 or x.shape[:-1] != g.shape[:-1]:
        raise ValueError(f"expected x[B, D, H, W, C] and g[B, D, H, W, F], "
                         f"got {tuple(x.shape)} and {tuple(g.shape)}")
    _backend.dtype_code(x)
    if g.dtype != x.dtype or g.device != x.device:
        raise ValueError("x and g must share dtype and device")


def flip_swap(w: torch.Tensor) -> torch.Tensor:
    """dgrad weights: spatial flip + in/out channel swap, [F, C, 3, 3, 3] ->
    [C, F, 3, 3, 3] (``_flip_swap`` of the JAX package in torch's layout)."""
    return w.flip(2, 3, 4).transpose(0, 1)


def conv3d_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv3d`` with padding 1, channels-last in and out."""
    _check(x, w)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _launch_fwd(x: torch.Tensor, w: torch.Tensor, key: str,
                na=None) -> torch.Tensor:
    """The forward kernel, counted under ``key``; ``na`` = (mean, rstd, act)
    selects ``conv3d_same_na_fwd``."""
    if not x.is_contiguous():
        raise ValueError("kernel needs a contiguous x[B, D, H, W, C]")
    B, D, H, W, C = x.shape
    Fo = w.shape[0]
    wp = w.permute(2, 3, 4, 1, 0).contiguous()
    y = torch.empty((B, D, H, W, Fo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        shape = (B, D, H, W, C, Fo, torch.cuda.current_stream().cuda_stream)
        if na is None:
            _build.call("conv3d_same_fwd", x.data_ptr(), wp.data_ptr(),
                        y.data_ptr(), _backend.dtype_code(x), *shape)
        else:
            mean, rstd, act = na
            _build.call("conv3d_same_na_fwd", x.data_ptr(), wp.data_ptr(),
                        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                        _backend.dtype_code(x), fused_norm._act_code(act),
                        *shape)
    launches[key] += 1
    return y


def conv3d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1, zero-pad-1 3^3 correlation: x[B, D, H, W, C] with torch
    weights w[F, C, 3, 3, 3] -> y[B, D, H, W, F] in x.dtype.

    The counterpart of ``cbim_tpu.ops.pallas.conv3d.conv3d_same`` (which
    takes w as [3, 3, 3, C, F]).  CUDA tensors launch the kernel, CPU
    tensors run the plain version.  No autograd: see :class:`Conv3dSame`."""
    _check(x, w)
    if not _backend.uses_kernels(x):
        return conv3d_same_plain(x, w)
    return _launch_fwd(x, w, "conv3d_same_fwd")


def conv3d_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of :func:`conv3d_same`: the forward kernel on the
    upstream gradient g[B, D, H, W, F] with ``flip_swap(w)``."""
    ws = flip_swap(w)
    _check(g, ws)
    if not _backend.uses_kernels(g):
        return conv3d_same_plain(g, ws)
    return _launch_fwd(g, ws, "conv3d_dgrad")


def conv3d_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv3d_wgrad`: ``torch.nn.grad.conv3d_weight``
    in fp32, torch's [F, C, 3, 3, 3]."""
    _check_wgrad(x, g)
    return torch.nn.grad.conv3d_weight(
        x.float().permute(0, 4, 1, 2, 3), (g.shape[-1], x.shape[-1], 3, 3, 3),
        g.float().permute(0, 4, 1, 2, 3), padding=1)


def wgrad_chunking(M: int, C: int, F: int, taps: int = 27
                   ) -> tuple[int, int]:
    """(rows_per_chunk, n_chunks) for a wgrad kernel's split reduction over
    M voxels (or pixels): a block owns a chunk and one (taps / 3 outer
    taps, c-tile, f-tile); the kw taps share it."""
    tiles = taps // 3 * -(-C // 64) * -(-F // 64)
    cap = max(1, _WGRAD_MAX_PARTIAL_BYTES // (taps * C * F * 4))
    n_chunks = max(1, min(_WGRAD_TARGET_BLOCKS // tiles, cap, 65535,
                          M // _WGRAD_MIN_ROWS))
    rows = -(-M // n_chunks)
    return rows, -(-M // rows)


def _launch_wgrad(x: torch.Tensor, g: torch.Tensor, na=None) -> torch.Tensor:
    """The wgrad kernel; ``na`` = (mean, rstd, act) selects
    ``conv3d_wgrad_na``."""
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("kernel needs contiguous x and g")
    B, D, H, W, C = x.shape
    Fo = g.shape[-1]
    M = B * D * H * W
    if M >= 2 ** 31:
        raise ValueError(f"conv3d_wgrad takes fewer than 2^31 voxels, got {M}")
    rows, n_chunks = wgrad_chunking(M, C, Fo)
    partial = torch.empty(n_chunks * 27 * C * Fo, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((3, 3, 3, C, Fo), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        shape = (B, D, H, W, C, Fo, rows, n_chunks,
                 torch.cuda.current_stream().cuda_stream)
        if na is None:
            _build.call("conv3d_wgrad", x.data_ptr(), g.data_ptr(),
                        partial.data_ptr(), dw.data_ptr(),
                        _backend.dtype_code(x), *shape)
        else:
            mean, rstd, act = na
            _build.call("conv3d_wgrad_na", x.data_ptr(), g.data_ptr(),
                        mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(),
                        dw.data_ptr(), _backend.dtype_code(x),
                        fused_norm._act_code(act), *shape)
    launches["conv3d_wgrad" if na is None else "conv3d_wgrad_na"] += 1
    return dw.permute(4, 3, 0, 1, 2)


def conv3d_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of :func:`conv3d_same`: x[B, D, H, W, C],
    g[B, D, H, W, F] -> dW[F, C, 3, 3, 3] float32 (torch's layout).

    The counterpart of ``cbim_tpu.ops.pallas.conv3d.conv3d_wgrad`` (which
    returns [3, 3, 3, C, F]).  CUDA tensors launch the kernel, CPU tensors
    run the plain version."""
    _check_wgrad(x, g)
    if not _backend.uses_kernels(x):
        return conv3d_wgrad_plain(x, g)
    return _launch_wgrad(x, g)


# ------------------------------------------------ fused preact conv (na)

def _check_na(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
              act) -> None:
    fused_norm._act_code(act)
    fused_norm._check_stats(x, mean, rstd)


def _normed(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
            act) -> torch.Tensor:
    """act((x - mean) * rstd) in x.dtype, x[B, D, H, W, C]: the tensor the
    fused kernels never write."""
    x3 = x.reshape(x.shape[0], -1, x.shape[-1])
    return fused_norm.inorm_apply_plain(x3, mean, rstd, act).view(x.shape)


def conv3d_same_na_plain(x: torch.Tensor, mean: torch.Tensor,
                         rstd: torch.Tensor, w: torch.Tensor,
                         act=None) -> torch.Tensor:
    """Plain version of :func:`conv3d_same_na`: ``inorm_apply_plain`` then
    ``conv3d_same_plain``."""
    _check(x, w)
    _check_na(x, mean, rstd, act)
    return conv3d_same_plain(_normed(x, mean, rstd, act), w)


def conv3d_same_na(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                   w: torch.Tensor, act=None) -> torch.Tensor:
    """The SAME 3^3 conv of act((x - mean) * rstd): x[B, D, H, W, C], mean
    and rstd float32 [B, C], torch weights w[F, C, 3, 3, 3] -> y[B, D, H,
    W, F] in x.dtype.  Zero padding applies to the normalised input.

    The counterpart of ``cbim_tpu.ops.pallas.conv3d.conv3d_same_cw_na``
    (NDHCW, stat [B, 2, C, 1], w [3, 3, 3, C, F]).  CUDA tensors launch
    ``conv3d_same_na_fwd``, CPU tensors run the plain version."""
    _check(x, w)
    _check_na(x, mean, rstd, act)
    if not _backend.uses_kernels(x):
        return conv3d_same_na_plain(x, mean, rstd, w, act)
    return _launch_fwd(x, w, "conv3d_same_na_fwd", (mean, rstd, act))


def conv3d_wgrad_na_plain(x: torch.Tensor, mean: torch.Tensor,
                          rstd: torch.Tensor, g: torch.Tensor,
                          act=None) -> torch.Tensor:
    """Plain version of :func:`conv3d_wgrad_na`: ``conv3d_wgrad_plain`` on
    ``inorm_apply_plain``'s output."""
    _check_wgrad(x, g)
    _check_na(x, mean, rstd, act)
    return conv3d_wgrad_plain(_normed(x, mean, rstd, act), g)


def conv3d_wgrad_na(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                    g: torch.Tensor, act=None) -> torch.Tensor:
    """Weight gradient of :func:`conv3d_same_na`: g[B, D, H, W, F] against
    act((x - mean) * rstd), recomputed where the kernel stages it ->
    dW[F, C, 3, 3, 3] float32.

    The counterpart of ``cbim_tpu.ops.pallas.conv3d.conv3d_wgrad_cw2_na``.
    CUDA tensors launch ``conv3d_wgrad_na``, CPU tensors run the plain
    version."""
    _check_wgrad(x, g)
    _check_na(x, mean, rstd, act)
    if not _backend.uses_kernels(x):
        return conv3d_wgrad_na_plain(x, mean, rstd, g, act)
    return _launch_wgrad(x, g, (mean, rstd, act))


class Conv3dSame(torch.autograd.Function):
    """Trainable :func:`conv3d_same` (the counterpart of ``conv3d_same_t``).

    Forward: the forward kernel.  Backward: dx by :func:`conv3d_dgrad`, dW
    by :func:`conv3d_wgrad` (fp32, cast to w's dtype), each only when
    needed.  Under CUDA autocast, x and w meet in bf16, as in the Flax
    modules' ``dtype=bfloat16``.  On the CPU the same formulas run through
    the plain versions.  The forward is pure, so recomputing it under
    activation checkpointing is safe."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d_same(x, w)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_dgrad(g, w)
        if ctx.needs_input_grad[1]:
            dw = conv3d_wgrad(x, g).to(w.dtype)
        return dx, dw


class ConvInormAct3d(torch.autograd.Function):
    """The fused preact conv, ``ConvInormAct3d.apply(x, w, eps, act)`` =
    conv3x3x3_same(act(instance_norm(x, eps))) over a channels-last
    x[B, D, H, W, C] with torch weights w[F, C, 3, 3, 3] (the counterpart of
    ``conv_inorm_act_cw_t``).

    Forward: ``inorm_stats`` (the port of ``_cw_stats``) and
    :func:`conv3d_same_na`; it saves x, w, mean and rstd, never the
    normalised tensor.  Backward, as ``_conv_na_bwd``: the gradient of the
    normalised input dxn = :func:`conv3d_dgrad` (g, w); dW =
    :func:`conv3d_wgrad_na`; dx = ``inorm_bwd_stats`` + ``inorm_bwd_apply``
    on (x, dxn), which fold the statistics' own dependence on x.  Each
    gradient only when needed; eps and act take none.  Under CUDA autocast,
    x and w meet in bf16, as in :class:`Conv3dSame`.  CPU tensors run the
    plain versions.  Pure, so safe to recompute under activation
    checkpointing."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, w, eps, act):
        _check(x, w)
        mean, rstd = fused_norm._stats(fused_norm._rows(x), eps)
        ctx.save_for_backward(x, w, mean, rstd)
        ctx.act = act
        return conv3d_same_na(x, mean, rstd, w, act)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        x, w, mean, rstd = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxn3 = fused_norm._rows(conv3d_dgrad(g, w))
            dx = fused_norm._backward(fused_norm._rows(x), dxn3, mean, rstd,
                                      ctx.act).view(x.shape)
        if ctx.needs_input_grad[1]:
            dw = conv3d_wgrad_na(x, mean, rstd, g, ctx.act).to(w.dtype)
        return dx, dw, None, None
