"""Stride-1 SAME 3x3 convolution, forward and backward: CUDA kernels, their
plain versions, and the ``torch.autograd.Function`` that trains through them.

Port of ``cbim_tpu/ops/pallas/conv2d.py``: ``conv2d_same``, the custom VJP
``conv2d_same_t`` (dgrad: the forward on ``_flip_swap2`` weights) and
``conv2d_wgrad``.  Three routes, chosen by :func:`conv2d_route` from the
dtype and the channel counts before any launch:

- bf16 with C and F multiples of 8: the tensor-core kernels
  ``conv2d_same_fwd_tc`` (``csrc/conv2d_tc.cu``; also the dgrad, counted
  under ``conv2d_dgrad_tc``) and ``conv2d_wgrad_tc``
  (``csrc/conv2d_wgrad_tc.cu``).  The forward's entry packs the weights in
  a first small kernel into the layout of :func:`pack_weights_tc2d` (its
  plain version, which also applies the dgrad's flip-swap); the wgrad
  splits its pixel tiles into chunks by :func:`wgrad_tc2d_chunking`.
- fp32 with C and F multiples of 8: the error-compensated TF32
  tensor-core kernels (3xTF32: each operand split into a TF32 hi and lo
  part, three TF32 products summed in fp32) ``conv2d_same_fwd_tf32``
  (``csrc/conv2d_tf32.cu``; also the dgrad, counted under
  ``conv2d_dgrad_tf32``) and ``conv2d_wgrad_tf32``
  (``csrc/conv2d_wgrad_tf32.cu``).  The forward's entry packs and splits
  the weights as :func:`pack_weights_tf32_2d` does;
  :func:`conv2d_same_tf32x3_plain` and :func:`conv2d_wgrad_tf32x3_plain`
  model the arithmetic, and ``wgrad_tc_chunking`` at 9 taps splits the
  wgrad's pixel tiles (:func:`pixel_tiles_tf32_2d`).
- everything else (other widths, such as a 1-channel input): the
  CUDA-core kernels of ``csrc/conv2d.cu``:

- ``conv2d_same_fwd``: x[B, H, W, C] (x) w[F, C, 3, 3] -> y[B, H, W, F]
  with fp32 sums, any B/H/W (the kernel masks its own edges).  It also
  computes the input gradient: the SAME correlation of the upstream
  gradient with flip-swapped weights (:func:`flip_swap`).  Those launches
  count under ``conv2d_dgrad``.
- ``conv2d_wgrad``: dW[3, 3, C, F] = sum over pixels of shifted x times g,
  a split-K reduction with fp32 partials per chunk of pixels, folded in a
  fixed order (no atomics).

The weight takes torch's layout; the CUDA-core forward's wrapper packs it
to [3, 3, C, F] (a copy of 9*C*F values) so the kernel reads rows of output
channels (the tensor-core entry packs its own), and the wgrad wrappers give
back torch's [F, C, 3, 3].  CPU tensors take the plain versions:
``F.conv2d`` with padding 1 and ``torch.nn.grad.conv2d_weight``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _backend
from . import _build
from .conv3d import (CUDA_CORE, TC_CHUNK, TENSOR_CORE, TF32_CHUNK,
                     TF32_PITCH, TF32_WGRAD_TILE, TF32X3, conv3d_route,
                     tc_tile_n, tf32_split, tf32_tile_n, wgrad_chunking,
                     wgrad_tc_chunking)

#: launches of each kernel since the last reset (plain calls do not count);
#: ``conv2d_dgrad``, ``conv2d_dgrad_tc`` and ``conv2d_dgrad_tf32`` count the
#: forward kernels' input-gradient launches
launches = {"conv2d_same_fwd": 0, "conv2d_dgrad": 0, "conv2d_wgrad": 0,
            "conv2d_same_fwd_tc": 0, "conv2d_dgrad_tc": 0,
            "conv2d_wgrad_tc": 0, "conv2d_same_fwd_tf32": 0,
            "conv2d_dgrad_tf32": 0, "conv2d_wgrad_tf32": 0}
#: the forward and dgrad launch counters of each route
FORWARD_KEYS = {TENSOR_CORE: ("conv2d_same_fwd_tc", "conv2d_dgrad_tc"),
                TF32X3: ("conv2d_same_fwd_tf32", "conv2d_dgrad_tf32"),
                CUDA_CORE: ("conv2d_same_fwd", "conv2d_dgrad")}

#: the tensor-core kernels: the widest output-channel tile of the forward
#: (its staging buffer and a streamed weight chunk must fit beside two
#: halo stages), the wgrad's pixel-tile width, its widest (c, f) tile, and
#: the blocks a wgrad pass aims for (one on each of 132 SMs)
TC2D_MAX_BN = 96
TC2D_TILE_W = 32
TC2D_WGRAD_MAX_TILE = 64
_TC2D_WGRAD_TARGET_BLOCKS = 132
#: the rows of the TF32 wgrad's (rows, 32) pixel tiles: two for each of
#: its three row parts
TF32_2D_TILE_H = 6


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


def conv2d_route(dtype: torch.dtype, C: int, F: int) -> str:
    """Which kernel family a CUDA call of :func:`conv2d_same`,
    :func:`conv2d_dgrad` or :func:`conv2d_wgrad` with C input and F output
    channels launches: the 3^3 conv's rule (``conv3d_route``), with C % 8
    == 0 and F % 8 == 0 (TMA's 16-byte strides) :data:`TENSOR_CORE` for
    bf16 and :data:`TF32X3` for fp32, else :data:`CUDA_CORE`.  Symmetric
    in C and F, so the dgrad (F -> C) takes its forward's route."""
    return conv3d_route(dtype, C, F)


def tc2d_tile_n(F: int) -> tuple[int, int]:
    """(BN, n_tiles) of the tensor-core forward: ``tc_tile_n`` up to
    :data:`TC2D_MAX_BN` (160 -> two of 96, 40 -> one of 64)."""
    return tc_tile_n(F, TC2D_MAX_BN)


def pack_weights_tc2d(w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """torch weights w[F, C, 3, 3] -> the tensor-core forward's layout
    [n_tiles, C chunks, kh, kw, 32, BN + 8]: for each (output tile,
    32-channel chunk) one contiguous block of 9 taps x 32 channels x BN
    output channels, rows padded by 8 values (16 bytes) so the kernel's
    ldmatrix rows fall on distinct banks.  Zeros past C, F and in the
    padding.  With ``flip``, the packing of ``flip_swap(w)`` (the dgrad's
    weights, [C, F] swapped).  The plain version of the packing kernel
    that ``conv2d_same_fwd_tc`` runs first."""
    if flip:
        w = flip_swap(w)
    Fo, C = w.shape[:2]
    bn, n_tiles = tc2d_tile_n(Fo)
    n_chunks = -(-C // TC_CHUNK)
    if (Fo, C) != (n_tiles * bn, n_chunks * TC_CHUNK):
        w = F.pad(w, (0, 0, 0, 0, 0, n_chunks * TC_CHUNK - C,
                      0, n_tiles * bn - Fo))
    wp = w.new_zeros((n_tiles, n_chunks, 3, 3, TC_CHUNK, bn + 8))
    wp[..., :bn] = w.reshape(n_tiles, bn, n_chunks, TC_CHUNK, 3, 3).permute(
        0, 2, 4, 5, 3, 1)
    return wp


def conv2d_same_packed_plain(x: torch.Tensor, wp: torch.Tensor,
                             F_out: int) -> torch.Tensor:
    """The tensor-core forward's arithmetic in plain PyTorch, from the
    packed weights of :func:`pack_weights_tc2d`: the sum over the 9 taps of
    the shifted, zero-padded x times that tap's [C, F] matrix, in fp32,
    cast once to x's dtype."""
    B, H, W, C = x.shape
    n_tiles, n_chunks = wp.shape[:2]
    bn = wp.shape[-1] - 8
    taps = wp[..., :bn].permute(2, 3, 1, 4, 0, 5).reshape(
        3, 3, n_chunks * TC_CHUNK, n_tiles * bn)[:, :, :C, :F_out]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    y = x.new_zeros((B, H, W, F_out), dtype=torch.float32)
    for kh in range(3):
        for kw in range(3):
            y += xp[:, kh:kh + H, kw:kw + W] @ taps[kh, kw].float()
    return y.to(x.dtype)


def conv2d_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv2d`` with padding 1, channels-last in and out."""
    _check(x, w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------- the TF32 route (3xTF32)

def pack_weights_tf32_2d(w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """torch weights w[F, C, 3, 3] (with ``flip``: the forward's, packed as
    ``flip_swap(w)``, the dgrad's) -> the TF32 forward's layout [n_tiles,
    C chunks, kh, part, kw, BN, 20], part 0 the TF32 hi and 1 the lo of
    ``tf32_split``: for each (output tile, 16-channel chunk, kh) step one
    contiguous block of both parts' 3 kw taps x BN output channels x 16
    input channels, each row of 16 padded to 20 values (80 bytes) so the
    kernel's ldmatrix rows fall on distinct banks (``pack_weights_tf32``'s
    rows).  BN from ``tf32_tile_n``.  Zeros past C, F and in the padding.
    The plain version of the packing kernel that ``conv2d_same_fwd_tf32``
    runs first."""
    if flip:
        w = flip_swap(w)
    Fo, C = w.shape[:2]
    bn, n_tiles = tf32_tile_n(Fo)
    n_chunks = -(-C // TF32_CHUNK)
    w = F.pad(w.float(), (0, 0, 0, 0, 0, n_chunks * TF32_CHUNK - C,
                          0, n_tiles * bn - Fo))
    # [n_tiles, chunks, kh, kw, bn, 16]
    w = w.reshape(n_tiles, bn, n_chunks, TF32_CHUNK, 3, 3).permute(
        0, 2, 4, 5, 1, 3)
    wp = w.new_zeros((n_tiles, n_chunks, 3, 2, 3, bn, TF32_PITCH))
    wp[..., :TF32_CHUNK] = torch.stack(tf32_split(w), dim=3)
    return wp


def conv2d_same_tf32x3_plain(x: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    """``conv2d_same_fwd_tf32``'s arithmetic in plain PyTorch (3xTF32): x
    and w each split into TF32 hi and lo parts (``tf32_split``), then y =
    x_lo w_hi + x_hi w_lo + x_hi w_hi, three SAME convs summed in fp32 (the
    dropped x_lo w_lo is 2^-22 of x w).  Not on the card's path: the CPU
    tests hold it against fp64 and the Pallas kernel."""
    _check(x, w)
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w)
    return (conv2d_same_plain(xl, wh) + conv2d_same_plain(xh, wl)
            + conv2d_same_plain(xh, wh))


def _launch_fwd(x: torch.Tensor, w: torch.Tensor, key: str) -> torch.Tensor:
    """The CUDA-core forward ``conv2d_same_fwd``, counted under ``key``."""
    if not x.is_contiguous():
        raise ValueError("kernel needs a contiguous x[B, H, W, C]")
    B, H, W, C = x.shape
    Fo = w.shape[0]
    wp = w.permute(2, 3, 1, 0).contiguous()
    y = torch.empty((B, H, W, Fo), dtype=x.dtype, device=x.device)
    _build.call("conv2d_same_fwd", x.data_ptr(), wp.data_ptr(), y.data_ptr(),
                _backend.dtype_code(x), B, H, W, C, Fo, device=x.device)
    launches[key] += 1
    return y


def _launch_fwd_tf32(x: torch.Tensor, w: torch.Tensor, key: str,
                     flip: bool = False) -> torch.Tensor:
    """The TF32 forward ``conv2d_same_fwd_tf32`` (fp32) on torch weights
    w[F, C, 3, 3] or, with ``flip``, on ``flip_swap(w)`` (the input
    gradient), counted under ``key``.  The entry packs and splits the
    weights as :func:`pack_weights_tf32_2d` does into scratch the wrapper
    allocates."""
    if not x.is_contiguous():
        raise ValueError("kernel needs a contiguous x[B, H, W, C]")
    B, H, W, C = x.shape
    Fo = w.shape[1] if flip else w.shape[0]
    bn, n_tiles = tf32_tile_n(Fo)
    w = w.contiguous()
    wp = torch.empty(n_tiles * -(-C // TF32_CHUNK) * 3 * 2 * 3 * bn
                     * TF32_PITCH, dtype=x.dtype, device=x.device)
    y = torch.empty((B, H, W, Fo), dtype=x.dtype, device=x.device)
    _build.call("conv2d_same_fwd_tf32", x.data_ptr(), w.data_ptr(),
                wp.data_ptr(), y.data_ptr(), B, H, W, C, Fo, bn, int(flip),
                device=x.device)
    launches[key] += 1
    return y


def _launch_route(route: str, x: torch.Tensor, w: torch.Tensor,
                  flip: bool = False) -> torch.Tensor:
    """The forward kernel of ``route`` on torch weights w (with ``flip``:
    on ``flip_swap(w)``, counted as a dgrad)."""
    key = FORWARD_KEYS[route][int(flip)]
    if route == TENSOR_CORE:
        return _launch_fwd_tc(x, w, key, flip=flip)
    if route == TF32X3:
        return _launch_fwd_tf32(x, w, key, flip=flip)
    return _launch_fwd(x, flip_swap(w) if flip else w, key)


def _launch_fwd_tc(x: torch.Tensor, w: torch.Tensor, key: str,
                   flip: bool = False) -> torch.Tensor:
    """The tensor-core forward ``conv2d_same_fwd_tc`` on torch weights
    w[F, C, 3, 3] or, with ``flip``, on ``flip_swap(w)`` (the input
    gradient; the entry's packing kernel applies the flip), counted under
    ``key``.  The entry packs the weights as :func:`pack_weights_tc2d`
    does into scratch the wrapper allocates."""
    if not x.is_contiguous():
        raise ValueError("kernel needs a contiguous x[B, H, W, C]")
    B, H, W, C = x.shape
    Fo = w.shape[1] if flip else w.shape[0]
    bn, n_tiles = tc2d_tile_n(Fo)
    w = w.contiguous()
    wp = torch.empty(n_tiles * -(-C // TC_CHUNK) * 9 * TC_CHUNK * (bn + 8),
                     dtype=x.dtype, device=x.device)
    y = torch.empty((B, H, W, Fo), dtype=x.dtype, device=x.device)
    _build.call("conv2d_same_fwd_tc", x.data_ptr(), w.data_ptr(),
                wp.data_ptr(), y.data_ptr(), B, H, W, C, Fo, bn, int(flip),
                device=x.device)
    launches[key] += 1
    return y


def conv2d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1, zero-pad-1 3x3 correlation: x[B, H, W, C] with torch
    weights w[F, C, 3, 3] -> y[B, H, W, F] in x.dtype.

    The counterpart of ``cbim_tpu.ops.pallas.conv2d.conv2d_same`` (which
    takes w as [3, 3, C, F]).  CUDA tensors launch the kernel of
    :func:`conv2d_route`, CPU tensors run the plain version.  No autograd:
    see :class:`Conv2dSame`."""
    _check(x, w)
    if not _backend.uses_kernels(x):
        return conv2d_same_plain(x, w)
    return _launch_route(conv2d_route(x.dtype, x.shape[-1], w.shape[0]), x,
                         w)


def conv2d_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of :func:`conv2d_same`: the forward kernel of the
    same route on the upstream gradient g[B, H, W, F] with
    ``flip_swap(w)``."""
    ws = flip_swap(w)
    _check(g, ws)
    if not _backend.uses_kernels(g):
        return conv2d_same_plain(g, ws)
    return _launch_route(conv2d_route(g.dtype, g.shape[-1], ws.shape[0]), g,
                         w, flip=True)


def conv2d_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv2d_wgrad`: ``torch.nn.grad.conv2d_weight``
    in fp32, torch's [F, C, 3, 3]."""
    _check_wgrad(x, g)
    return torch.nn.grad.conv2d_weight(
        x.float().permute(0, 3, 1, 2), (g.shape[-1], x.shape[-1], 3, 3),
        g.float().permute(0, 3, 1, 2), padding=1)


def wgrad_tc2d_tiles(C: int, F: int) -> tuple[int, int, int]:
    """(TC, TF, TH) of ``conv2d_wgrad_tc``: the (c, f) tile of dW a block
    owns, 32 where the width is at most 32 else 64 (all of C and F at the
    ACDC widths), and the rows of its (TH, 32) pixel tiles: 8 at a 32 x 32
    tile, 4 where a 64-wide tile doubles the staged bytes."""
    tc = 32 if C <= 32 else TC2D_WGRAD_MAX_TILE
    tf = 32 if F <= 32 else TC2D_WGRAD_MAX_TILE
    return tc, tf, 8 if tc == tf == 32 else 4


def pixel_tiles_tc2d(B: int, H: int, W: int, C: int, F: int) -> int:
    """The tensor-core wgrad's pixel tiles: (TH, 32) boxes covering each
    sample, ragged ones included."""
    th = wgrad_tc2d_tiles(C, F)[2]
    return B * -(-H // th) * -(-W // TC2D_TILE_W)


def wgrad_tc2d_chunking(n_tiles: int, C: int, F: int) -> tuple[int, int]:
    """(tiles_per_chunk, n_chunks) for ``conv2d_wgrad_tc``'s split
    reduction over ``n_tiles`` pixel tiles: a block owns a chunk of tiles
    and one (c, f) tile of dW for all 9 taps, about one block an SM, and
    every chunk holds at least one tile.  So the fp32 partials take at most
    132 x 9 x 64 x 64 x 4 bytes (19.5 MB), or one dW where dW has more
    tiles than the card SMs: within ``_WGRAD_MAX_PARTIAL_BYTES``."""
    tc, tf, _ = wgrad_tc2d_tiles(C, F)
    tiles = -(-C // tc) * -(-F // tf)
    n_chunks = max(1, min(_TC2D_WGRAD_TARGET_BLOCKS // tiles, n_tiles))
    per = -(-n_tiles // n_chunks)
    return per, -(-n_tiles // per)


def _launch_wgrad_tc(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The tensor-core wgrad ``conv2d_wgrad_tc`` and its fold."""
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("kernel needs contiguous x and g")
    B, H, W, C = x.shape
    Fo = g.shape[-1]
    per, n_chunks = wgrad_tc2d_chunking(pixel_tiles_tc2d(B, H, W, C, Fo), C,
                                        Fo)
    partial = torch.empty(n_chunks * 9 * C * Fo, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((3, 3, C, Fo), dtype=torch.float32, device=x.device)
    _build.call("conv2d_wgrad_tc", x.data_ptr(), g.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), B, H, W, C, Fo, per,
                n_chunks, device=x.device)
    launches["conv2d_wgrad_tc"] += 1
    return dw.permute(3, 2, 0, 1)


def conv2d_wgrad_tf32x3_plain(x: torch.Tensor, g: torch.Tensor
                              ) -> torch.Tensor:
    """``conv2d_wgrad_tf32``'s arithmetic in plain PyTorch (3xTF32): x and
    g each split into TF32 hi and lo parts (``tf32_split``), then dW =
    wgrad(x_lo, g_hi) + wgrad(x_hi, g_lo) + wgrad(x_hi, g_hi), three
    weight gradients summed in fp32 (the dropped x_lo g_lo is 2^-22 of
    x g), torch's [F, C, 3, 3].  Not on the card's path: the CPU tests hold
    it against fp64 and the Pallas kernel."""
    _check_wgrad(x, g)
    (xh, xl), (gh, gl) = tf32_split(x), tf32_split(g)
    return (conv2d_wgrad_plain(xl, gh) + conv2d_wgrad_plain(xh, gl)
            + conv2d_wgrad_plain(xh, gh))


def pixel_tiles_tf32_2d(B: int, H: int, W: int) -> int:
    """The TF32 wgrad's pixel tiles: (:data:`TF32_2D_TILE_H`, 32) boxes
    covering each sample, ragged ones included."""
    return B * -(-H // TF32_2D_TILE_H) * -(-W // TC2D_TILE_W)


def _launch_wgrad_tf32(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 wgrad ``conv2d_wgrad_tf32`` (fp32) and its fold."""
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("kernel needs contiguous x and g")
    B, H, W, C = x.shape
    Fo = g.shape[-1]
    if B * H * W >= 2 ** 31:
        raise ValueError(f"conv2d_wgrad takes fewer than 2^31 pixels, got "
                         f"{B * H * W}")
    # a block owns a chunk of pixel tiles and one (16, 32) (c, f) tile of
    # dW for all 9 taps, as conv3d_wgrad_tf32 does for 27
    per, n_chunks = wgrad_tc_chunking(pixel_tiles_tf32_2d(B, H, W), C, Fo,
                                      TF32_WGRAD_TILE, taps=9)
    partial = torch.empty(n_chunks * 9 * C * Fo, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((3, 3, C, Fo), dtype=torch.float32, device=x.device)
    _build.call("conv2d_wgrad_tf32", x.data_ptr(), g.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), B, H, W, C, Fo, per,
                n_chunks, device=x.device)
    launches["conv2d_wgrad_tf32"] += 1
    return dw.permute(3, 2, 0, 1)


def _launch_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The CUDA-core wgrad ``conv2d_wgrad`` and its fold."""
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
    _build.call("conv2d_wgrad", x.data_ptr(), g.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), _backend.dtype_code(x),
                B, H, W, C, Fo, rows, n_chunks, device=x.device)
    launches["conv2d_wgrad"] += 1
    return dw.permute(3, 2, 0, 1)


def conv2d_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of :func:`conv2d_same`: x[B, H, W, C], g[B, H, W, F]
    -> dW[F, C, 3, 3] float32 (torch's layout).

    The counterpart of ``cbim_tpu.ops.pallas.conv2d.conv2d_wgrad`` (which
    returns [3, 3, C, F]).  CUDA tensors launch the kernel of
    :func:`conv2d_route`, CPU tensors run the plain version."""
    _check_wgrad(x, g)
    if not _backend.uses_kernels(x):
        return conv2d_wgrad_plain(x, g)
    route = conv2d_route(x.dtype, x.shape[-1], g.shape[-1])
    if route == TENSOR_CORE:
        return _launch_wgrad_tc(x, g)
    if route == TF32X3:
        return _launch_wgrad_tf32(x, g)
    return _launch_wgrad(x, g)


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
