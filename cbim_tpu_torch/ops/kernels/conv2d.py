"""Stride-1 SAME 3x3 convolution, forward and backward: CUDA kernels, their
plain versions, and the ``torch.autograd.Function`` that trains through them.

Port of ``cbim_tpu/ops/pallas/conv2d.py``: ``conv2d_same``, the custom VJP
``conv2d_same_t`` (dgrad: the forward on ``_flip_swap2`` weights) and
``conv2d_wgrad``.  Two kernels in ``csrc/conv2d.cu``:

- ``conv2d_same_fwd``: x[B, H, W, C] (x) w[F, C, 3, 3] -> y[B, H, W, F]
  with fp32 sums, any B/H/W (the kernel masks its own edges).  It also
  computes the input gradient: the SAME correlation of the upstream
  gradient with flip-swapped weights (:func:`flip_swap`).  Those launches
  count under ``conv2d_dgrad``.
- ``conv2d_wgrad``: dW[3, 3, C, F] = sum over pixels of shifted x times g,
  a split-K reduction with fp32 partials per chunk of pixels, folded in a
  fixed order (no atomics).

The weight takes torch's layout; the forward wrapper packs it to
[3, 3, C, F] (a copy of 9*C*F values) so the kernel reads rows of output
channels, and the wgrad wrapper gives back torch's [F, C, 3, 3].  CPU
tensors take the plain versions: ``F.conv2d`` with padding 1 and
``torch.nn.grad.conv2d_weight``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _backend
from . import _build
from .conv3d import wgrad_chunking

#: launches of each kernel since the last reset (plain calls do not count);
#: ``conv2d_dgrad`` counts the forward kernel's input-gradient launches
launches = {"conv2d_same_fwd": 0, "conv2d_dgrad": 0, "conv2d_wgrad": 0}


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected x[B, H, W, C], got {tuple(x.shape)}")
    C = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[1:]) != (C, 3, 3):
        raise ValueError(f"expected w[F, {C}, 3, 3], got {tuple(w.shape)}")
    _backend.dtype_code(x)
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError("x and w must share dtype and device")


def _check_wgrad(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 4 or g.dim() != 4 or x.shape[:-1] != g.shape[:-1]:
        raise ValueError(f"expected x[B, H, W, C] and g[B, H, W, F], "
                         f"got {tuple(x.shape)} and {tuple(g.shape)}")
    _backend.dtype_code(x)
    if g.dtype != x.dtype or g.device != x.device:
        raise ValueError("x and g must share dtype and device")


def flip_swap(w: torch.Tensor) -> torch.Tensor:
    """dgrad weights: spatial flip + in/out channel swap, [F, C, 3, 3] ->
    [C, F, 3, 3] (``_flip_swap2`` of the JAX package in torch's layout)."""
    return w.flip(2, 3).transpose(0, 1)


def conv2d_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv2d`` with padding 1, channels-last in and out."""
    _check(x, w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _launch_fwd(x: torch.Tensor, w: torch.Tensor, key: str) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("kernel needs a contiguous x[B, H, W, C]")
    B, H, W, C = x.shape
    Fo = w.shape[0]
    wp = w.permute(2, 3, 1, 0).contiguous()
    y = torch.empty((B, H, W, Fo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _build.call("conv2d_same_fwd", x.data_ptr(), wp.data_ptr(),
                    y.data_ptr(), _backend.dtype_code(x), B, H, W, C, Fo,
                    torch.cuda.current_stream().cuda_stream)
    launches[key] += 1
    return y


def conv2d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1, zero-pad-1 3x3 correlation: x[B, H, W, C] with torch
    weights w[F, C, 3, 3] -> y[B, H, W, F] in x.dtype.

    The counterpart of ``cbim_tpu.ops.pallas.conv2d.conv2d_same`` (which
    takes w as [3, 3, C, F]).  CUDA tensors launch the kernel, CPU tensors
    run the plain version.  No autograd: see :class:`Conv2dSame`."""
    _check(x, w)
    if not _backend.uses_kernels(x):
        return conv2d_same_plain(x, w)
    return _launch_fwd(x, w, "conv2d_same_fwd")


def conv2d_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of :func:`conv2d_same`: the forward kernel on the
    upstream gradient g[B, H, W, F] with ``flip_swap(w)``."""
    ws = flip_swap(w)
    _check(g, ws)
    if not _backend.uses_kernels(g):
        return conv2d_same_plain(g, ws)
    return _launch_fwd(g, ws, "conv2d_dgrad")


def conv2d_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv2d_wgrad`: ``torch.nn.grad.conv2d_weight``
    in fp32, torch's [F, C, 3, 3]."""
    _check_wgrad(x, g)
    return torch.nn.grad.conv2d_weight(
        x.float().permute(0, 3, 1, 2), (g.shape[-1], x.shape[-1], 3, 3),
        g.float().permute(0, 3, 1, 2), padding=1)


def conv2d_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of :func:`conv2d_same`: x[B, H, W, C], g[B, H, W, F]
    -> dW[F, C, 3, 3] float32 (torch's layout).

    The counterpart of ``cbim_tpu.ops.pallas.conv2d.conv2d_wgrad`` (which
    returns [3, 3, C, F]).  CUDA tensors launch the kernel, CPU tensors run
    the plain version."""
    _check_wgrad(x, g)
    if not _backend.uses_kernels(x):
        return conv2d_wgrad_plain(x, g)
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("kernel needs contiguous x and g")
    B, H, W, C = x.shape
    Fo = g.shape[-1]
    M = B * H * W
    if M >= 2 ** 31:
        raise ValueError(f"conv2d_wgrad takes fewer than 2^31 pixels, got {M}")
    rows, n_chunks = wgrad_chunking(M, C, Fo, taps=9)
    partial = torch.empty(n_chunks * 9 * C * Fo, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((3, 3, C, Fo), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.call("conv2d_wgrad", x.data_ptr(), g.data_ptr(),
                    partial.data_ptr(), dw.data_ptr(), _backend.dtype_code(x),
                    B, H, W, C, Fo, rows, n_chunks,
                    torch.cuda.current_stream().cuda_stream)
    launches["conv2d_wgrad"] += 1
    return dw.permute(3, 2, 0, 1)


class Conv2dSame(torch.autograd.Function):
    """Trainable :func:`conv2d_same` (the counterpart of ``conv2d_same_t``).

    Forward: the forward kernel.  Backward: dx by :func:`conv2d_dgrad`, dW
    by :func:`conv2d_wgrad` (fp32, cast to w's dtype), each only when
    needed.  Under CUDA autocast, x and w meet in bf16, as in the Flax
    modules' ``dtype=bfloat16``.  On the CPU the same formulas run through
    the plain versions."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv2d_same(x, w)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_dgrad(g, w)
        if ctx.needs_input_grad[1]:
            dw = conv2d_wgrad(x, g).to(w.dtype)
        return dx, dw
