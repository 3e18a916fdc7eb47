"""The probe kernels: instruments that measure the port's own kernels and
the card, and their plain versions.

Port of the JAX package's TPU probes (``tools/probe_bandwidth.py``,
``tools/probe_lhst_dot.py``, ``tools/probe_cw_dissect.py``), which lie on
no serving or training path.  Kernels in ``csrc/probes.cu`` and, for the
ladder, ``csrc/conv3d.cu``:

- ``probe_copy_scale``: y = 2 x in bf16, with 16-byte or 2-byte accesses
  and 2048 or 8192 elements a block: the HBM rate an elementwise pass
  reaches (the TPU probe's ``scale_kernel``);
- ``probe_dot_t``: out[t] = W^T A[t], contracting dim 0 of both operands,
  on bf16 tensor cores (``mma.sync`` m16n8k16, fp32 sums, both operands
  transposed by ``ldmatrix.trans``), one block per (t, W rows, 128-column
  slab) or weight-stationary across the slabs of its t (the TPU probe's
  ``slabloop`` and ``batched`` kernels);
- ``probe_gemm``: out[t] = a[t] b, the same kernel with a row-major left
  operand: the 1k^2 calibration (``big_square``);
- ``conv3d_same_fwd_ladder``: ``conv3d_same_fwd`` cut after a phase
  (load, stage, fma, full); ``full`` is the production kernel itself.

Each wrapper launches its kernel for a CUDA tensor (and counts the launch
in :data:`launches`, apart from the production kernels' counters) and runs
its plain version for a CPU tensor: ``x * 2``, ``torch.einsum`` in fp32
cast to bf16, and ``F.conv3d`` in fp32 for the ladder's ``full`` rung (the
cut rungs compute nothing to compare and run on the card only).
"""

from __future__ import annotations

import torch

from .. import _backend
from . import _build, conv3d

#: launches of each probe kernel since the last reset (plain calls do not
#: count)
launches = {"probe_copy_scale": 0, "probe_dot_t": 0, "probe_gemm": 0,
            "conv3d_same_fwd_ladder": 0}

#: elements a copy-scale block takes
COPY_BLOCKS = (2048, 8192)
#: the tile of ``probe_dot_t`` (rows of W, depth) and of ``probe_gemm``
#: (rows, depth chunk); both write 128-column slabs
DOT_TILE = (96, 96)
GEMM_TILE = (128, 32)
SLAB = 128
#: the ladder's rungs, in order, and the tile widths it sweeps
PHASES = ("load", "stage", "fma", "full")
LADDER_BN = (32, 64)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------- copy-scale

def _check_copy(x: torch.Tensor, vec: bool, block: int) -> None:
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"copy_scale takes a contiguous bf16 tensor, got "
                         f"{x.dtype} contiguous={x.is_contiguous()}")
    if block not in COPY_BLOCKS:
        raise ValueError(f"block must be one of {COPY_BLOCKS}, got {block}")
    if vec and (x.data_ptr() % 16 or x.numel() % 8):
        raise ValueError("the 16-byte path needs a 16-byte-aligned tensor of "
                         f"a multiple of 8 elements, got {x.numel()} at "
                         f"{x.data_ptr():#x}")


def copy_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`copy_scale` (and its library call)."""
    return x * 2


def copy_scale(x: torch.Tensor, vec: bool = True,
               block: int = 2048) -> torch.Tensor:
    """y = 2 x, bf16, any shape (a flat pass over the contiguous buffer).
    ``vec``: 16-byte accesses of 8 values (needs a 16-byte-aligned buffer
    of a multiple of 8 values, else raises), else 2-byte ones; ``block``:
    elements a block takes.  The counterpart of ``tools/probe_bandwidth.py``'s
    ``scale_kernel``."""
    _check_copy(x, vec, block)
    if not _backend.uses_kernels(x):
        return copy_scale_plain(x)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.call("probe_copy_scale", x.data_ptr(), y.data_ptr(),
                    x.numel(), int(vec), block, _stream())
    launches["probe_copy_scale"] += 1
    return y


# ---------------------------------------------------- tensor-core dot probes

def _check_bf16(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.bfloat16 or t.device != ts[0].device:
            raise ValueError("the dot probes take bf16 tensors on one device")


def dot_t_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dot_t`: fp32 einsum, cast to bf16."""
    return torch.einsum("kn,tkl->tnl", w.float(), a.float()).to(torch.bfloat16)


def dot_t(a: torch.Tensor, w: torch.Tensor,
          stationary: bool = True) -> torch.Tensor:
    """out[t] = w^T a[t]: a [T, K, L], w [K, N] -> out [T, N, L] bf16, fp32
    sums; both operands contract their dim 0 (``jax.lax.dot_general`` with
    dimension numbers (((0,), (0,)), ((), ())) of ``tools/probe_lhst_dot.py``).
    ``stationary``: a block keeps its rows of w in shared memory across
    every 128-column slab of its t; else it reloads them for each slab.
    The kernel takes N % 96 == 0, K % 96 == 0, L % 128 == 0."""
    _check_bf16(a, w)
    if a.dim() != 3 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"expected a[T, K, L] and w[K, N], got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if not _backend.uses_kernels(a):
        return dot_t_plain(a, w)
    T, K, L = a.shape
    N = w.shape[1]
    if N % DOT_TILE[0] or K % DOT_TILE[1] or L % SLAB:
        raise ValueError(f"the kernel takes N % {DOT_TILE[0]}, K % "
                         f"{DOT_TILE[1]} and L % {SLAB} == 0, got N={N} "
                         f"K={K} L={L}")
    a, w = a.contiguous(), w.contiguous()
    out = torch.empty((T, N, L), dtype=torch.bfloat16, device=a.device)
    with torch.cuda.device(a.device):
        _build.call("probe_dot_t", a.data_ptr(), w.data_ptr(), out.data_ptr(),
                    T, K, N, L, L // SLAB if stationary else 1, _stream())
    launches["probe_dot_t"] += 1
    return out


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gemm`: fp32 einsum, cast to bf16."""
    return torch.einsum("tmk,kn->tmn", a.float(), b.float()).to(torch.bfloat16)


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[t] = a[t] b: a [T, M, K], b [K, N] -> out [T, M, N] bf16, fp32
    sums (``big_square`` of ``tools/probe_lhst_dot.py``).  The kernel takes
    M % 128, N % 128 and K % 32 == 0."""
    _check_bf16(a, b)
    if a.dim() != 3 or b.dim() != 2 or a.shape[2] != b.shape[0]:
        raise ValueError(f"expected a[T, M, K] and b[K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not _backend.uses_kernels(a):
        return gemm_plain(a, b)
    T, M, K = a.shape
    N = b.shape[1]
    if M % GEMM_TILE[0] or N % SLAB or K % GEMM_TILE[1]:
        raise ValueError(f"the kernel takes M % {GEMM_TILE[0]}, N % {SLAB} "
                         f"and K % {GEMM_TILE[1]} == 0, got M={M} N={N} "
                         f"K={K}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((T, M, N), dtype=torch.bfloat16, device=a.device)
    with torch.cuda.device(a.device):
        _build.call("probe_gemm", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    T, M, N, K, _stream())
    launches["probe_gemm"] += 1
    return out


# ------------------------------------------------------ the conv's ladder

def conv3d_same_fwd_ladder_plain(x: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    """Plain version of the ladder's ``full`` rung: ``F.conv3d`` in fp32,
    cast to x's dtype."""
    return conv3d.conv3d_same_plain(x.float(), w.float()).to(x.dtype)


def production_bn(F: int) -> int:
    """The tile width ``conv3d_same_fwd`` launches for F output channels."""
    return 32 if F <= 32 else 64


def conv3d_same_fwd_ladder(x: torch.Tensor, w: torch.Tensor,
                           phase: str = "full",
                           bn: int | None = None) -> torch.Tensor:
    """``conv3d_same_fwd`` on x[B, D, H, W, C] with torch weights w[F, C,
    3, 3, 3], cut after ``phase`` (:data:`PHASES`) at tile width ``bn``
    (32 or 64; default the production one).  ``full`` at the production
    width launches the very kernel ``conv3d.conv3d_same`` does; a cut rung
    returns a tensor of which only one value per thread was written.  The
    16-byte staging path only (C % 4 == 0).  A CPU tensor runs the plain
    version of ``full`` and refuses a cut rung."""
    conv3d._check(x, w)
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    Fo = w.shape[0]
    bn = production_bn(Fo) if bn is None else bn
    if bn not in LADDER_BN:
        raise ValueError(f"bn must be one of {LADDER_BN}, got {bn}")
    if not _backend.uses_kernels(x):
        if phase != "full":
            raise ValueError(f"the {phase!r} rung computes no conv: it runs "
                             f"on the card only")
        return conv3d_same_fwd_ladder_plain(x, w)
    B, D, H, W, C = x.shape
    if not x.is_contiguous() or C % 4 or x.data_ptr() % (4 * x.element_size()):
        raise ValueError("the ladder takes a contiguous x with C % 4 == 0 "
                         "(the 16-byte staging path)")
    wp = w.permute(2, 3, 4, 1, 0).contiguous()
    y = torch.empty((B, D, H, W, Fo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _build.call("conv3d_same_fwd_ladder", x.data_ptr(), wp.data_ptr(),
                    y.data_ptr(), _backend.dtype_code(x), B, D, H, W, C, Fo,
                    PHASES.index(phase), bn, _stream())
    launches["conv3d_same_fwd_ladder"] += 1
    return y
