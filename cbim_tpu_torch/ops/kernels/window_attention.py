"""Fused (shifted-)window attention, forward only: the CUDA kernel and its
plain version.

Port of ``cbim_tpu/ops/pallas/window_attention.py``
(``fused_window_attention``, whose semantics ``reference_window_attention``
spells out):

    o = softmax(q k^T D^-1/2 + bias) v      per (window, head), fp32 softmax

with q, k, v of shape (B, H, N, D), B = windows x batch.  The TPU kernel took
the additive bias dense, (B or 1, H, N, N); here it comes as its two parts,
the relative-position bias ``rel_bias`` (H, N, N) and, in shifted blocks, the
region id of every token of each window, ``region`` int32 (nW, N): the
kernel adds -100 where the ids of query and key differ in window ``b % nW``
(``window_partition`` is batch-major), which is how ``compute_attn_mask``
builds its mask.  ``csrc/window_attention.cu`` holds the kernel.

Like the TPU kernel it has no backward (the JAX package keeps it
inference-only): on a CUDA tensor the wrapper raises when autograd would
need a gradient, rather than run anything else.  CPU tensors take the plain
version (einsum, add, fp32 softmax, einsum), which autograd can trace.

The kernel writes its (B, H, N, D) output laid out as (B, N, H, D), so
merging the heads (``o.transpose(1, 2).reshape(B, N, H * D)``) copies
nothing on its path.
"""

from __future__ import annotations

import torch

from .. import _backend
from . import _build

#: launches of the kernel since the last reset (plain calls do not count)
launches = {"window_attention": 0}

#: the head widths the kernel is built for
KERNEL_HEAD_DIMS = (16, 32)
#: shared memory a block may use on an H100 (dynamic, after opt-in)
_MAX_SMEM = 227 * 1024
#: the additive mask between tokens of different regions
MASK_VALUE = -100.0


def _check(q, k, v, rel_bias, region) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected q[B, H, N, D], got {tuple(q.shape)}")
    _backend.dtype_code(q)
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device")
    B, H, N, _ = q.shape
    if tuple(rel_bias.shape) != (H, N, N) or rel_bias.device != q.device:
        raise ValueError(f"expected rel_bias[{H}, {N}, {N}] on {q.device}, "
                         f"got {tuple(rel_bias.shape)} on {rel_bias.device}")
    if region is not None:
        if (region.dim() != 2 or region.shape[1] != N
                or B % region.shape[0] != 0 or region.device != q.device
                or region.dtype != torch.int32):
            raise ValueError(
                f"expected region int32[nW, {N}] with nW dividing {B} on "
                f"{q.device}, got {region.dtype}{tuple(region.shape)} on "
                f"{region.device}")


def region_mask(region: torch.Tensor) -> torch.Tensor:
    """(nW, N) region ids -> the (nW, N, N) float32 additive mask: -100
    where the ids of query i and key j differ, else 0."""
    diff = region[:, :, None] != region[:, None, :]
    return torch.where(diff, MASK_VALUE, 0.0).to(torch.float32)


def window_attention_plain(q, k, v, rel_bias, region=None) -> torch.Tensor:
    """Plain version of :func:`window_attention`: einsum, add, fp32
    softmax, einsum; the output in q.dtype."""
    _check(q, k, v, rel_bias, region)
    B, H, N, D = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q.float() * D ** -0.5, k.float())
    s = s + rel_bias.float()
    if region is not None:
        nW = region.shape[0]
        s = (s.view(B // nW, nW, H, N, N)
             + region_mask(region)[None, :, None]).view(B, H, N, N)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


def window_attention(q, k, v, rel_bias, region=None) -> torch.Tensor:
    """o = softmax(q k^T D^-1/2 + rel_bias - 100 [region_i != region_j]) v.

    q, k, v: (B, H, N, D), float32 or bfloat16, one set of strides with unit
    stride on D (views of one packed qkv tensor qualify); rel_bias: (H, N, N)
    (used in float32); region: int32 (nW, N) or None.  Returns (B, H, N, D)
    in q.dtype (from the kernel, laid out (B, N, H, D)).

    The counterpart of ``cbim_tpu.ops.pallas.window_attention.
    fused_window_attention`` with its bias split in two.  CUDA tensors
    launch the kernel (D in 16, 32); CPU tensors run the plain version."""
    _check(q, k, v, rel_bias, region)
    if not _backend.uses_kernels(q):
        return window_attention_plain(q, k, v, rel_bias, region)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, rel_bias)):
        raise RuntimeError(
            "window_attention has no backward kernel (nor has the TPU "
            "kernel it ports); run it under torch.no_grad() or "
            "torch.inference_mode()")
    B, H, N, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    if (q.stride(-1) != 1 or k.stride() != q.stride()
            or v.stride() != q.stride()):
        raise ValueError("kernel needs q, k, v with one set of strides and "
                         f"unit stride on D, got {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")
    if (2 * N * D + N) * 4 > _MAX_SMEM:
        raise ValueError(f"a window of N={N}, D={D} does not fit the "
                         f"kernel's shared memory")
    bias_t = rel_bias.float().transpose(1, 2).contiguous()   # [h][key][query]
    region = None if region is None else region.contiguous()
    o = torch.empty((B, N, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    nW = 1 if region is None else region.shape[0]
    with torch.cuda.device(q.device):
        _build.call("window_attention", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), bias_t.data_ptr(),
                    None if region is None else region.data_ptr(),
                    o.data_ptr(), _backend.dtype_code(q), B, H, N, D, nW,
                    *q.stride()[:3], *o.stride()[:3],
                    torch.cuda.current_stream().cuda_stream)
    launches["window_attention"] += 1
    return o
