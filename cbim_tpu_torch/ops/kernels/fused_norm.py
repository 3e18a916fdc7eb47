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

Each is the CUDA implementation of a ``torch.library`` custom op of the
same name (``torch.ops.cbim.inorm_stats`` ...; ``_library``), whose CPU
implementation is the plain PyTorch version beside it (fp32 math, one
cast); :class:`InstanceNormAct` and the fused preact conv call the ops,
and so does :class:`SpatialInstanceNormAct`, the same norm of one H slab
of a volume sharded over ranks (the 'spatial' mesh axis), its statistics
merged over the ranks (:func:`merge_stats`).
The ops take the activation as its code (:data:`ACT_NAMES`).  Unlike the
TPU gate
(``fused_norm.usable``: lane-dense C only), the kernels take every C: the
C % 128 rule was a TPU lane-padding artifact.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ...parallel.spatial import gather_pairs, group_sum
from .. import _backend
from ..activations import gelu_grad, get_act
from . import _build, _library

#: launches of each kernel since the last reset (plain calls do not count)
launches = {"inorm_stats": 0, "inorm_apply": 0, "inorm_bwd_stats": 0,
            "inorm_bwd_apply": 0}

_ACT_CODES = {None: 0, False: 0, "none": 0, "relu": 1, "gelu": 2}
#: the activation of each code the ops take
ACT_NAMES = {0: None, 1: "relu", 2: "gelu"}

#: blocks the stats pass aims for (a few waves over 132 SMs)
_TARGET_BLOCKS = 2048
_MIN_ROWS_PER_CHUNK = 256


def supported_act(act) -> bool:
    """Whether the kernels fuse ``act`` (``fused_norm.supported_act`` of the
    JAX package): none, relu or exact-erf gelu."""
    return act in _ACT_CODES


def _act_code(act) -> int:
    if not supported_act(act):
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
    _backend.check_capability(x3.device)
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
    _build.call("inorm_stats", x3.data_ptr(), _backend.dtype_code(x3), B, S,
                C, rows, n_chunks, float(eps), partial.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), device=x3.device)
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
    _build.call("inorm_apply", x3.data_ptr(), y.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), _backend.dtype_code(x3), code, B, S, C,
                device=x3.device)
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
    """Each of ``stats`` a contiguous float32 [B, C] on the device of x3
    [B, ..., C]."""
    B, C = x3.shape[0], x3.shape[-1]
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
    _build.call("inorm_bwd_stats", x3.data_ptr(), dy3.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), _backend.dtype_code(x3),
                code, B, S, C, rows, n_chunks, partial.data_ptr(),
                red.data_ptr(), device=x3.device)
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
    _build.call("inorm_bwd_apply", x3.data_ptr(), dy3.data_ptr(),
                dx.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                red.data_ptr(), _backend.dtype_code(x3), code, B, S, C,
                device=x3.device)
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


def _stats(x3: torch.Tensor, eps: float):
    """(mean, rstd) of x3[B, S, C]: the op ``cbim::inorm_stats`` (the
    kernel for a CUDA tensor, the plain version for a CPU one)."""
    return torch.ops.cbim.inorm_stats(x3, float(eps))


def _backward(x3: torch.Tensor, dy3: torch.Tensor, mean: torch.Tensor,
              rstd: torch.Tensor, act) -> torch.Tensor:
    """dx of act(instance_norm(x3)) from dy3 (both [B, S, C]): the ops
    ``cbim::inorm_bwd_stats`` and ``cbim::inorm_bwd_apply``."""
    code = _act_code(act)
    red = torch.ops.cbim.inorm_bwd_stats(x3, dy3, mean, rstd, code)
    return torch.ops.cbim.inorm_bwd_apply(x3, dy3, mean, rstd, red, code)


class InstanceNormAct(torch.autograd.Function):
    """Trainable :func:`instance_norm_act` (the counterpart of
    ``_instance_norm_act3``'s custom VJP): ``InstanceNormAct.apply(x, eps,
    act)`` over a channels-last x (B, *spatial, C).

    Forward: the ops ``inorm_stats`` + ``inorm_apply``, saving x, mean and
    rstd (as ``_inorm_fwd``).  Backward: ``inorm_bwd_stats`` +
    ``inorm_bwd_apply``; eps and act take no gradient.  Under CUDA
    autocast, x is cast to bf16.  CPU tensors run the plain versions of
    all four.  Pure, so safe to
    recompute under activation checkpointing."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, eps, act):
        _act_code(act)
        x3 = _rows(x)
        mean, rstd = _stats(x3, eps)
        y = torch.ops.cbim.inorm_apply(x3, mean, rstd, _act_code(act))
        ctx.save_for_backward(x3, mean, rstd)
        ctx.act = act
        return y.view(x.shape)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x3, mean, rstd = ctx.saved_tensors
        dy3 = dy.to(x3.dtype).contiguous().view(x3.shape)
        dx = _backward(x3, dy3, mean, rstd, ctx.act)
        return dx.view(dy.shape), None, None


def merge_stats(mean: torch.Tensor, rstd: torch.Tensor, eps: float, group
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (mean, rstd) of the whole volume from each H slab's (mean, rstd)
    over its rows, the slabs of ``group`` all of one size (the mesh's
    divisibility rule): Chan's parallel rule, in fp64, on every slab's
    (mean, variance) gathered in one collective, each variance recovered
    as rstd^-2 - eps.  The global mean is the mean of the slab means; the
    global variance the mean of (slab variance + (slab mean - global
    mean)^2).  The recovery costs only rstd's fp32 rounding relative to
    var + eps, the term the output divides by."""
    m, var = (torch.stack(t) for t in zip(*gather_pairs(
        mean.double(), rstd.double().pow(-2) - eps, group)))
    mean_g = m.mean(0)
    var_g = (var + (m - mean_g).square()).mean(0).clamp_min(0)
    return mean_g.float(), torch.rsqrt(var_g + eps).float()


def _spatial_backward(x3: torch.Tensor, dy3: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor, act, group) -> torch.Tensor:
    """:func:`_backward` of one H slab under the volume's statistics: the
    slab's ``inorm_bwd_stats`` (means over its rows) averaged over the
    group's equal slabs, then ``inorm_bwd_apply``."""
    code = _act_code(act)
    red = torch.ops.cbim.inorm_bwd_stats(x3, dy3, mean, rstd, code)
    red = (group_sum(red.double(), group)
           / dist.get_world_size(group)).float()
    return torch.ops.cbim.inorm_bwd_apply(x3, dy3, mean, rstd, red, code)


class SpatialInstanceNormAct(torch.autograd.Function):
    """:class:`InstanceNormAct` of one H slab of a volume sharded over the
    process ``group`` (``parallel.spatial``),
    ``SpatialInstanceNormAct.apply(x, eps, act, group)`` over a
    channels-last slab x (B, *spatial, C): the whole volume's statistics,
    on the same kernels.

    Forward: ``inorm_stats`` on the slab, the (mean, rstd) merged over the
    group (:func:`merge_stats`), ``inorm_apply`` with them.  Backward:
    ``inorm_bwd_stats`` on the slab, averaged over the group, then
    ``inorm_bwd_apply``.  Every peer of the group calls it in the same
    order, as each collective needs."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, eps, act, group):
        code = _act_code(act)
        x3 = _rows(x)
        mean, rstd = merge_stats(*_stats(x3, eps), eps, group)
        y = torch.ops.cbim.inorm_apply(x3, mean, rstd, code)
        ctx.save_for_backward(x3, mean, rstd)
        ctx.act, ctx.group = act, group
        return y.view(x.shape)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x3, mean, rstd = ctx.saved_tensors
        dy3 = dy.to(x3.dtype).contiguous().view(x3.shape)
        dx = _spatial_backward(x3, dy3, mean, rstd, ctx.act, ctx.group)
        return dx.view(dy.shape), None, None, None


def instance_norm_act(x: torch.Tensor, eps: float = 1e-4,
                      act=None) -> torch.Tensor:
    """InstanceNorm (affine-free, biased variance over the spatial axes)
    followed by ``act``, over a channels-last x (B, *spatial, C).

    The counterpart of ``cbim_tpu.ops.pallas.fused_norm.instance_norm_act``.
    CUDA tensors go through the kernels, CPU tensors through the plain
    versions; both train through :class:`InstanceNormAct`."""
    return InstanceNormAct.apply(x, eps, act)


# ------------------------------------------------------------ the custom ops

def _stats_fake(x3, eps):
    B, C = x3.shape[0], x3.shape[-1]
    return (x3.new_empty((B, C), dtype=torch.float32),
            x3.new_empty((B, C), dtype=torch.float32))


def _apply_cpu(x3, mean, rstd, act):
    return inorm_apply_plain(x3, mean, rstd, ACT_NAMES[act])


def _apply_cuda(x3, mean, rstd, act):
    return inorm_apply(x3, mean, rstd, ACT_NAMES[act])


def _apply_fake(x3, mean, rstd, act):
    return torch.empty_like(x3)


def _bwd_stats_cpu(x3, dy3, mean, rstd, act):
    return inorm_bwd_stats_plain(x3, dy3, mean, rstd, ACT_NAMES[act])


def _bwd_stats_cuda(x3, dy3, mean, rstd, act):
    return inorm_bwd_stats(x3, dy3, mean, rstd, ACT_NAMES[act])


def _bwd_stats_fake(x3, dy3, mean, rstd, act):
    return x3.new_empty((x3.shape[0], 2, x3.shape[-1]), dtype=torch.float32)


def _bwd_apply_cpu(x3, dy3, mean, rstd, red, act):
    return inorm_bwd_apply_plain(x3, dy3, mean, rstd, red, ACT_NAMES[act])


def _bwd_apply_cuda(x3, dy3, mean, rstd, red, act):
    return inorm_bwd_apply(x3, dy3, mean, rstd, red, ACT_NAMES[act])


def _bwd_apply_fake(x3, dy3, mean, rstd, red, act):
    return torch.empty_like(x3)


_library.define("inorm_stats", "(Tensor x, float eps) -> (Tensor, Tensor)",
                inorm_stats_plain, inorm_stats, _stats_fake)
_library.define("inorm_apply",
                "(Tensor x, Tensor mean, Tensor rstd, int act) -> Tensor",
                _apply_cpu, _apply_cuda, _apply_fake)
_library.define("inorm_bwd_stats", "(Tensor x, Tensor dy, Tensor mean, "
                "Tensor rstd, int act) -> Tensor",
                _bwd_stats_cpu, _bwd_stats_cuda, _bwd_stats_fake)
_library.define("inorm_bwd_apply", "(Tensor x, Tensor dy, Tensor mean, "
                "Tensor rstd, Tensor red, int act) -> Tensor",
                _bwd_apply_cpu, _bwd_apply_cuda, _bwd_apply_fake)
