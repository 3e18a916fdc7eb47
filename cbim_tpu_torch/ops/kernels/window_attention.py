"""Fused (shifted-)window attention, forward only: the CUDA kernel and its
plain versions.

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
builds its mask.  ``csrc/window_attention.cu`` holds the kernel, on the
tensor cores: in fp32 3xTF32 (q, k, v and the softmax weights P each split
into TF32 hi and lo parts, three products summed in fp32), in bf16 the
stored values with P rounded to bf16; online softmax over chunks of 32 keys
in base 2, each chunk's P V summed apart.  :func:`window_attention_tf32x3_plain`
and :func:`window_attention_bf16_plain` model that arithmetic in plain
PyTorch for the CPU tests.

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
#: shared memory a block may use on an H100 (dynamic, after opt-in): the
#: kernel's ``kMaxSmem``
_MAX_SMEM = 227 * 1024
#: the additive mask between tokens of different regions
MASK_VALUE = -100.0
#: keys per online-softmax step of the kernel; it pads N to a multiple
KEY_CHUNK = 32
LOG2E = 1.4426950408889634


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


def padded_keys(N: int) -> int:
    """N rounded up to the kernel's 32-key chunk."""
    return -(-N // KEY_CHUNK) * KEY_CHUNK


def kernel_smem_bytes(N: int, D: int, dtype: torch.dtype) -> int:
    """The kernel's staged K and V (fp32: TF32 hi and lo planes of each;
    bf16: the values) and region ids at N keys rounded up to the chunk:
    the formula of ``csrc/window_attention.cu`` (its ``launch`` refuses
    past ``_MAX_SMEM`` too, only as a guard of the wrapper's check)."""
    Np = padded_keys(N)
    parts, size = (2, 4) if dtype == torch.float32 else (1, 2)
    return 2 * parts * Np * D * size + 4 * Np


def _check_kernel_view(q, k, v) -> None:
    """The kernel stages rows of q, k, v with 16-byte copies: one set of
    strides, unit stride on D, 16-byte aligned bases and (batch, head, row)
    strides of 16-byte multiples.  A packed qkv tensor's views qualify (row
    stride 3 H D values); anything else raises."""
    if (q.stride(-1) != 1 or k.stride() != q.stride()
            or v.stride() != q.stride()):
        raise ValueError("kernel needs q, k, v with one set of strides and "
                         f"unit stride on D, got {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")
    elt = q.element_size()
    if (any(t.data_ptr() % 16 for t in (q, k, v))
            or any(s * elt % 16 for s in q.stride()[:3])):
        raise ValueError("kernel needs 16-byte aligned q, k, v with (batch, "
                         "head, row) strides of 16-byte multiples, got "
                         f"strides {q.stride()} of {elt}-byte values")


def base2_bias(rel_bias: torch.Tensor) -> torch.Tensor:
    """The kernel's bias: float32 [H, Np, Np] (Np = :func:`padded_keys`),
    rel_bias * log2(e) for rows and keys below N, -inf for keys past N
    (they weigh nothing) and 0 for rows past N (finite, never stored).
    The plain version of the entry's first kernel (``base2_bias_kernel``),
    which reads rel_bias at its strides."""
    H, N, _ = rel_bias.shape
    Np = padded_keys(N)
    out = torch.zeros((H, Np, Np), dtype=torch.float32,
                      device=rel_bias.device)
    out[:, :N, :N] = rel_bias.float() * LOG2E
    out[:, :, N:] = float("-inf")
    return out


def _online_softmax_pv(s2, v_parts, pv, chunk: int = KEY_CHUNK):
    """o = sum_j 2^(s2_j - m) v_j / sum_j 2^(s2_j - m) the kernels' way:
    over chunks of ``chunk`` keys, a running max m and row sum l (fp32),
    the running o rescaled by 2^(m_old - m_new) and each chunk's P V (from
    ``pv(p, chunk's v parts)``) computed apart and added."""
    B, H, N, M = s2.shape
    m = torch.full((B, H, N, 1), float("-inf"))
    l = torch.zeros((B, H, N, 1))
    o = torch.zeros((B, H, N, v_parts[0].shape[-1]))
    for n0 in range(0, M, chunk):
        sc = s2[..., n0:n0 + chunk]
        mn = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(sc - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + pv(p, [t[..., n0:n0 + chunk, :] for t in v_parts])
        m = mn
    return o / l


def _base2_scores(q, k, rel_bias, region, qk):
    """s2 = qk(q, k) log2(e) D^-1/2 + the base-2 bias (- 100 log2(e) where
    the region ids differ), the kernels' scores."""
    B, H, N, D = q.shape
    s = qk(q, k) * (LOG2E / D ** 0.5) + base2_bias(rel_bias)[:, :N, :N]
    if region is not None:
        nW = region.shape[0]
        s = (s.view(B // nW, nW, H, N, N)
             + LOG2E * region_mask(region)[None, :, None]).view(B, H, N, N)
    return s


def _key_pairs(t: torch.Tensor) -> torch.Tensor:
    """t's keys (dim -2) in the TF32 P V's k-slot order within each 8: slot
    u < 4 is key 2u, slot u + 4 key 2u + 1 (keys past a multiple of 8 stay
    last)."""
    N = t.shape[-2]
    n8 = N // 8 * 8
    perm = torch.arange(n8).view(-1, 4, 2).transpose(1, 2).reshape(-1)
    return torch.cat([t[..., perm, :], t[..., n8:, :]], dim=-2)


def window_attention_tf32x3_plain(q, k, v, rel_bias, region=None
                                  ) -> torch.Tensor:
    """The fp32 kernel's arithmetic in plain PyTorch (3xTF32): q, k and v
    each split into TF32 hi and lo parts (``conv3d.tf32_split``), S = q_lo
    k_hi + q_hi k_lo + q_hi k_hi, the base-2 scores of
    :func:`base2_bias`, then the online softmax over chunks of 32 keys
    with P split as well and each chunk's P V = P_lo V_hi + P_hi V_lo +
    P_hi V_hi summed apart (keys in the kernel's k-slot order) before it
    joins the running o.  Not on the card's path: the CPU tests hold it
    against fp64, the plain version and the Pallas kernel."""
    from .conv3d import tf32_split
    _check(q, k, v, rel_bias, region)
    (qh, ql), (kh, kl), (vh, vl) = (tf32_split(t) for t in (q, k, v))

    def qk(_q, _k):
        return sum(torch.einsum("bhnd,bhmd->bhnm", a, b)
                   for a, b in ((ql, kh), (qh, kl), (qh, kh)))

    def pv(p, parts):
        ph, pl = tf32_split(p)
        vh_c, vl_c = (_key_pairs(t) for t in parts)
        ph, pl = (_key_pairs(t.transpose(-1, -2)).transpose(-1, -2)
                  for t in (ph, pl))
        return sum(torch.einsum("bhnm,bhmd->bhnd", a, b)
                   for a, b in ((pl, vh_c), (ph, vl_c), (ph, vh_c)))

    s2 = _base2_scores(q, k, rel_bias, region, qk)
    return _online_softmax_pv(s2, (vh, vl), pv).to(q.dtype)


def window_attention_bf16_plain(q, k, v, rel_bias, region=None
                                ) -> torch.Tensor:
    """The bf16 kernel's arithmetic in plain PyTorch: q k in fp32 from the
    bf16 values, the base-2 scores, the online softmax over chunks of 32
    keys, P rounded to bf16 for each chunk's P V (fp32 sums; the row sums
    l from the unrounded P), the output rounded to bf16 once."""
    _check(q, k, v, rel_bias, region)

    def qk(_q, _k):
        return torch.einsum("bhnd,bhmd->bhnm", _q.float(), _k.float())

    def pv(p, parts):
        return torch.einsum("bhnm,bhmd->bhnd", p.bfloat16().float(),
                            parts[0].float())

    s2 = _base2_scores(q, k, rel_bias, region, qk)
    return _online_softmax_pv(s2, (v,), pv).to(q.dtype)


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
    _check_kernel_view(q, k, v)
    Np = padded_keys(N)
    if kernel_smem_bytes(N, D, q.dtype) > _MAX_SMEM:
        raise ValueError(f"a window of N={N}, D={D} in {q.dtype} does not "
                         f"fit the kernel's shared memory "
                         f"({kernel_smem_bytes(N, D, q.dtype)} bytes)")
    rel_bias = rel_bias.float()
    # the kernel's base-2, padded bias (base2_bias), written by the entry
    bias2 = torch.empty((H, Np, Np), dtype=torch.float32, device=q.device)
    region = None if region is None else region.contiguous()
    o = torch.empty((B, N, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    nW = 1 if region is None else region.shape[0]
    _build.call("window_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                rel_bias.data_ptr(),
                None if region is None else region.data_ptr(),
                bias2.data_ptr(), o.data_ptr(), _backend.dtype_code(q), B, H,
                N, Np, D, nW, *q.stride()[:3], *rel_bias.stride(),
                *o.stride()[:3], device=q.device)
    launches["window_attention"] += 1
    return o
