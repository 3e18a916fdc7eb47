"""The probe kernels: instruments that measure the port's own kernels and
the card, and their plain versions.

Port of the JAX package's TPU probes (``tools/probe_bandwidth.py``,
``tools/probe_lhst_dot.py``, ``tools/probe_cw_dissect.py``), which lie on
no serving or training path.  Kernels in ``csrc/probes.cu``,
``csrc/dot_t_wgmma.cu``, ``csrc/gemm_wgmma.cu`` and, for the ladder,
``csrc/conv3d_tc.cu`` and ``csrc/conv3d_tf32.cu``:

- ``probe_copy_scale``: y = 2 x in bf16, with 16-byte or 2-byte accesses
  and 2048 or 8192 elements a block: the HBM rate an elementwise pass
  reaches (the TPU probe's ``scale_kernel``);
- ``probe_dot_t``: out[t] = W^T A[t], contracting dim 0 of both operands
  (the TPU probe's ``slabloop`` and ``batched`` kernels), on ``wgmma``
  m64n128k16: W read as stored through an MN-major (transpose-A)
  descriptor, A[t] through the transpose-B one, both brought by TMA; N
  padded to m64 blocks (five at N = 288), one tile a (t, 128 columns of
  L); one producer warp and two consumer warpgroups on alternate tiles,
  one persistent block a SM; each m block's sums rounded into a swizzled
  staging slot and TMA-stored as 256-byte rows while the next block's
  MMAs run.  Weight-stationary (W loaded once a block) or reloading W
  with every tile.  Bound by bytes (1.202 ms at the TPU probe's shape,
  three quarters of them stores);
- ``probe_gemm``: out[t] = a[t] b, the 1k^2 calibration (``big_square``),
  on ``wgmma`` (m64n256k16, b read transposed from its stored [K][N]), both
  operands brought by TMA into a four-stage ring, one producer warpgroup
  and two consumer warpgroups, one persistent block a SM: bound by
  operations (0.139 ms at 989 TFLOP/s at the full size);
- ``conv3d_same_fwd_ladder``: the 3^3 forwards the main path launches,
  cut after a phase (:data:`PHASES`): bf16 the tensor-core kernel of
  ``conv3d_same_fwd_tc``, fp32 the unfused 3xTF32 kernel of
  ``conv3d_same_fwd_tf32``, at the tiles their pickers choose between
  (:data:`LADDER_TILES`); ``full`` at :func:`production_tile` is the very
  launch ``conv3d.conv3d_same`` makes, so the rungs' deltas say where a
  production conv spends its time (the card has no ``ncu``).

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
#: ``probe_dot_t``'s shape rule: K up to DOT_MAX_K (the depth its boxes
#: pad K to), N a multiple of 8 (16-byte rows for TMA) up to DOT_MAX_N
#: (five m64 blocks), L a multiple of DOT_SLAB (its TMA boxes' width; a
#: tile is two of them, a ragged last one clipped)
DOT_MAX_K, DOT_MAX_N, DOT_SLAB = 96, 320, 64
#: ``probe_gemm``'s block tile (rows, columns) and K step: the kernel takes
#: M, N and K multiples of these
GEMM_TILE = (128, 256, 64)
#: the ladder's rungs, in order: the weight packing alone, then the kernel
#: cut after its copies, its fragment loads (and fp32's TF32 split), its
#: MMAs (and fp32's per-step fold), and whole
PHASES = ("pack", "copy", "frag", "mma", "full")
#: the (BN, MT) tiles the ladder sweeps in each dtype: the production
#: pickers' choices (bf16 at BN 32: 512- or 256-voxel boxes by the
#: big-tile rule of ``csrc/conv3d_tc.cu``; fp32: ``conv3d.tf32_tile_n``'s
#: two)
LADDER_TILES = {torch.bfloat16: ((32, 4), (32, 2)),
                torch.float32: ((32, 4), (64, 2))}
#: SMs of the H100, which the bf16 big-tile rule counts
_SMS = 132


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
    _build.call("probe_copy_scale", x.data_ptr(), y.data_ptr(), x.numel(),
                int(vec), block, device=x.device)
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


def check_dot_t_shape(T: int, K: int, N: int, L: int) -> None:
    """Raise ValueError unless ``probe_dot_t``'s kernel takes a[T, K, L] and
    w[K, N]: 1 <= K <= 96, N % 8 == 0 with 8 <= N <= 320, L a positive
    multiple of 64, T >= 1 and T * L / 64 below 2^31 (the C entry refuses
    the same).  So K = 192 or N = 384 raise: an m block needs all of K
    of both operands in shared memory at once, and at K = 192 W alone
    takes 120 KB, more than the ring and the staging leave; at N = 384
    the six m64 blocks of a resident W, the ring and the staging pass the
    227 KB a block may have."""
    if (T < 1 or K < 1 or K > DOT_MAX_K or N < 8 or N > DOT_MAX_N or N % 8
            or L < DOT_SLAB or L % DOT_SLAB
            or T * (L // DOT_SLAB) >= 2 ** 31):
        raise ValueError(
            f"the kernel takes 1 <= K <= {DOT_MAX_K}, N % 8 == 0 with 8 <= N "
            f"<= {DOT_MAX_N}, L % {DOT_SLAB} == 0 and T >= 1, got T={T} "
            f"K={K} N={N} L={L}")


def dot_t(a: torch.Tensor, w: torch.Tensor,
          stationary: bool = True) -> torch.Tensor:
    """out[t] = w^T a[t]: a [T, K, L], w [K, N] -> out [T, N, L] bf16, fp32
    sums; both operands contract their dim 0 (``jax.lax.dot_general`` with
    dimension numbers (((0,), (0,)), ((), ())) of ``tools/probe_lhst_dot.py``).
    ``stationary``: a block keeps w in shared memory for all its tiles;
    else it reloads w with every 128-column tile.  The kernel takes the
    shapes :func:`check_dot_t_shape` passes, in 16-byte aligned buffers."""
    _check_bf16(a, w)
    if a.dim() != 3 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"expected a[T, K, L] and w[K, N], got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if not _backend.uses_kernels(a):
        return dot_t_plain(a, w)
    T, K, L = a.shape
    N = w.shape[1]
    check_dot_t_shape(T, K, N, L)
    a, w = a.contiguous(), w.contiguous()
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the kernel's TMA loads need 16-byte aligned a and w")
    out = torch.empty((T, N, L), dtype=torch.bfloat16, device=a.device)
    _build.call("probe_dot_t", a.data_ptr(), w.data_ptr(), out.data_ptr(), T,
                K, N, L, int(stationary), device=a.device)
    launches["probe_dot_t"] += 1
    return out


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gemm`: fp32 einsum, cast to bf16."""
    return torch.einsum("tmk,kn->tmn", a.float(), b.float()).to(torch.bfloat16)


def check_gemm_shape(M: int, N: int, K: int) -> None:
    """Raise ValueError unless ``probe_gemm``'s kernel takes a[T, M, K] .
    b[K, N]: M, N and K positive multiples of :data:`GEMM_TILE`."""
    bm, bn, bk = GEMM_TILE
    if min(M, N, K) < 1 or M % bm or N % bn or K % bk:
        raise ValueError(f"the kernel takes M % {bm}, N % {bn} and K % {bk} "
                         f"== 0, got M={M} N={N} K={K}")


def gemm(a: torch.Tensor, b: torch.Tensor, store: bool = True
         ) -> torch.Tensor:
    """out[t] = a[t] b: a [T, M, K], b [K, N] -> out [T, M, N] bf16, fp32
    sums (``big_square`` of ``tools/probe_lhst_dot.py``).  The kernel takes
    the shapes :func:`check_gemm_shape` passes.  ``store=False`` (the card
    only) skips the kernel's epilogue stores and returns out unwritten: the
    mainloop's time."""
    _check_bf16(a, b)
    if a.dim() != 3 or b.dim() != 2 or a.shape[2] != b.shape[0]:
        raise ValueError(f"expected a[T, M, K] and b[K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not _backend.uses_kernels(a):
        if not store:
            raise ValueError("store=False times the kernel: the card only")
        return gemm_plain(a, b)
    T, M, K = a.shape
    N = b.shape[1]
    check_gemm_shape(M, N, K)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((T, M, N), dtype=torch.bfloat16, device=a.device)
    _build.call("probe_gemm", a.data_ptr(), b.data_ptr(), out.data_ptr(), T,
                M, N, K, int(store), device=a.device)
    launches["probe_gemm"] += 1
    return out


# ------------------------------------------------------ the conv's ladder

def conv3d_same_fwd_ladder_plain(x: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    """Plain version of the ladder's ``full`` rung: ``F.conv3d`` in fp32,
    cast to x's dtype."""
    return conv3d.conv3d_same_plain(x.float(), w.float()).to(x.dtype)


def production_tile(dtype: torch.dtype, shape) -> tuple[int, int]:
    """The (BN, MT) tile ``conv3d.conv3d_same`` launches for x of ``dtype``
    at ``shape`` = (B, D, H, W, C, F): in bf16 ``conv3d.tc_tile_n``'s BN,
    with MT 4 (512-voxel boxes) where those boxes give at least two blocks
    an SM, else MT 2 (``conv3d_same_fwd_tc`` in ``csrc/conv3d_tc.cu``); in
    fp32 ``conv3d.tf32_tile_n``'s BN, MT 4 at BN 32 and 2 at 64."""
    B, D, H, W, _, Fo = shape
    if dtype == torch.float32:
        bn = conv3d.tf32_tile_n(Fo)[0]
        return bn, 4 if bn == 32 else 2
    bn, n_tiles = conv3d.tc_tile_n(Fo)
    big_tiles = B * -(-D // 4) * -(-H // 8) * -(-W // 16) * n_tiles
    return bn, 4 if bn <= 64 and big_tiles >= 2 * _SMS else 2


def conv3d_same_fwd_ladder(x: torch.Tensor, w: torch.Tensor,
                           phase: str = "full",
                           tile: tuple[int, int] | None = None
                           ) -> torch.Tensor:
    """The 3^3 forward that ``conv3d.conv3d_same`` launches for x[B, D, H,
    W, C] (bf16: the tensor-core kernel; fp32: the unfused 3xTF32 one) with
    torch weights w[F, C, 3, 3, 3], cut after ``phase`` (:data:`PHASES`)
    at ``tile`` = (BN, MT) (one of :data:`LADDER_TILES`; default
    :func:`production_tile`).  Each rung runs the entry's weight-packing
    kernel first, as production does (``pack`` runs it alone).  ``full`` at
    the production tile is the very launch ``conv3d_same`` makes, and at
    the other tile the same arithmetic; a cut rung returns a tensor of
    which only one value per thread was written.  The card path takes C
    and F multiples of 8 (the tensor-core routes).  A CPU tensor runs the
    plain version of ``full`` and refuses a cut rung."""
    conv3d._check(x, w)
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    if x.dtype not in LADDER_TILES:
        raise ValueError(f"the ladder takes fp32 or bf16, got {x.dtype}")
    B, D, H, W, C = x.shape
    Fo = w.shape[0]
    tile = (production_tile(x.dtype, (B, D, H, W, C, Fo)) if tile is None
            else tuple(tile))
    if tile not in LADDER_TILES[x.dtype]:
        raise ValueError(f"tile must be one of {LADDER_TILES[x.dtype]} in "
                         f"{x.dtype}, got {tile}")
    if not _backend.uses_kernels(x):
        if phase != "full":
            raise ValueError(f"the {phase!r} rung computes no conv: it runs "
                             f"on the card only")
        return conv3d_same_fwd_ladder_plain(x, w)
    route = conv3d.conv3d_route(x.dtype, C, Fo)
    if route == conv3d.CUDA_CORE or not x.is_contiguous():
        raise ValueError("the ladder cuts the tensor-core forwards: a "
                         "contiguous x with C and F multiples of 8")
    bn, mt = tile
    w = w.contiguous()
    wp = torch.empty(conv3d.packed_numel(route, C, Fo, bn), dtype=x.dtype,
                     device=x.device)
    y = torch.empty((B, D, H, W, Fo), dtype=x.dtype, device=x.device)
    _build.call("conv3d_same_fwd_ladder", x.data_ptr(), w.data_ptr(),
                wp.data_ptr(), y.data_ptr(), _backend.dtype_code(x), B, D, H,
                W, C, Fo, PHASES.index(phase), bn, mt, device=x.device)
    launches["conv3d_same_fwd_ladder"] += 1
    return y
