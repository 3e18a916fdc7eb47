"""Stride-1 SAME 3^3 convolution, forward and backward: CUDA kernels, their
plain versions, and the ``torch.autograd.Function`` that trains through them.

Port of ``cbim_tpu/ops/pallas/conv3d.py``: ``conv3d_same`` (and its NDHCW
twins ``conv3d_same_cw``/``conv3d_same_cw2``, which compute the same thing
in another layout), the custom VJP ``conv3d_same_t``, and ``conv3d_wgrad``
(and ``_cw``/``_cw2``).  Three routes, chosen by :func:`conv3d_route` from
the dtype and the channel counts before any launch:

- bf16 with C and F multiples of 8: the tensor-core kernels
  ``conv3d_same_fwd_tc`` (``csrc/conv3d_tc.cu``; also the dgrad, counted
  under ``conv3d_dgrad_tc``) and ``conv3d_wgrad_tc``
  (``csrc/conv3d_wgrad_tc.cu``), and for the fused norm-act pair
  ``conv3d_same_na_fwd_tc`` (``csrc/conv3d_na_tc.cu``) and
  ``conv3d_wgrad_na_tc`` (``csrc/conv3d_wgrad_na_tc.cu``).  The forwards'
  entries pack the weights in a first small kernel into the layout of
  :func:`pack_weights_tc` (its plain version); the wgrads split their voxel
  tiles into chunks by :func:`wgrad_tc_chunking`.
- fp32 with C and F multiples of 8: the error-compensated TF32 tensor-core
  forwards of ``csrc/conv3d_tf32.cu`` (3xTF32: each operand split into a
  TF32 hi and lo part, three TF32 products summed in fp32),
  ``conv3d_same_fwd_tf32`` (also the dgrad, counted under
  ``conv3d_dgrad_tf32``) and ``conv3d_same_na_fwd_tf32``; their entries
  pack and split the weights as :func:`pack_weights_tf32` does, and
  :func:`conv3d_same_tf32x3_plain` models their arithmetic.  The weight
  gradient is ``conv3d_wgrad_tf32`` (``csrc/conv3d_wgrad_tf32.cu``, the
  same split on the tensor cores; :func:`conv3d_wgrad_tf32x3_plain` models
  it, :func:`wgrad_tc_chunking` splits its voxel tiles), and the fused
  pair's ``conv3d_wgrad_na_tf32`` (``csrc/conv3d_wgrad_na_tf32.cu``, the
  same kernel normalising each x halo in its split;
  :func:`conv3d_wgrad_na_tf32x3_plain` models it).
- everything else (other widths): the CUDA-core kernels of
  ``csrc/conv3d.cu``, ``csrc/conv3d_wgrad.cu`` and
  ``csrc/conv3d_wgrad_na.cu``:

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
custom VJP ``conv_inorm_act_cw_t``: on the CUDA-core route the same two
kernels with a norm-act prologue on their staged input rows,
``conv3d_same_na_fwd`` and ``conv3d_wgrad_na``; on the tensor-core route
``conv3d_same_na_fwd_tc`` and ``conv3d_wgrad_na_tc``, which normalise each
staged halo value once in shared memory (:func:`conv3d_same_na_tiled_plain`
and :func:`conv3d_wgrad_na_tiled_plain` are their decompositions in plain
PyTorch); on the TF32 route ``conv3d_same_na_fwd_tf32``, which does the
same in fp32, and ``conv3d_wgrad_na_tf32``.  So the normalised tensor
never exists in device memory.
The statistics are ``fused_norm.inorm_stats`` (``_cw_stats`` computes the
same per-(b, c) mean and rstd in the TPU layout).  :class:`ConvInormAct3d`
trains through them, and :class:`SpatialConvInormAct3d` through the same
kernels on one H slab of a volume sharded over ranks (the 'spatial' mesh
axis: the slab's halo planes exchanged, the statistics merged).

The weight takes torch's layout; the CUDA-core forward's wrapper packs it
to [3, 3, 3, C, F] (a copy of 27*C*F values) so the kernel reads rows of
output channels (the tensor-core and TF32 entries pack their own), and the
wgrad wrappers give back torch's [F, C, 3, 3, 3].
CPU tensors take the plain versions: ``F.conv3d`` with padding 1 and
``torch.nn.grad.conv3d_weight`` (on ``inorm_apply_plain``'s output for the
fused pair).

Each public kernel function (:func:`conv3d_same`, :func:`conv3d_dgrad`,
:func:`conv3d_wgrad`, :func:`conv3d_same_na`, :func:`conv3d_wgrad_na`)
checks its arguments and calls the ``torch.library`` custom op of its name
(``torch.ops.cbim.conv3d_same`` ...; ``_library``): its CUDA
implementation (``conv3d_same_cuda`` ...) picks the route, launches and
counts; its CPU implementation is the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...parallel import spatial
from .. import _backend
from . import _build, _library, fused_norm

#: launches of each kernel since the last reset (plain calls do not count);
#: ``conv3d_dgrad`` counts the forward kernel's input-gradient launches
launches = {"conv3d_same_fwd": 0, "conv3d_dgrad": 0, "conv3d_wgrad": 0,
            "conv3d_same_na_fwd": 0, "conv3d_wgrad_na": 0,
            "conv3d_same_fwd_tc": 0, "conv3d_dgrad_tc": 0,
            "conv3d_wgrad_tc": 0, "conv3d_same_na_fwd_tc": 0,
            "conv3d_wgrad_na_tc": 0, "conv3d_same_fwd_tf32": 0,
            "conv3d_dgrad_tf32": 0, "conv3d_same_na_fwd_tf32": 0,
            "conv3d_wgrad_tf32": 0, "conv3d_wgrad_na_tf32": 0}

#: the routes of :func:`conv3d_route`: bf16 tensor cores, fp32 as 3xTF32
#: on the tensor cores, CUDA cores
TENSOR_CORE, TF32X3, CUDA_CORE = "tensor_core", "tf32x3", "cuda_core"
#: the launch counter of each route's forward, dgrad and fused forward
#: (the wgrads: ``conv3d_wgrad_tc``/``conv3d_wgrad_na_tc`` on the bf16
#: tensor-core route, ``conv3d_wgrad_tf32``/``conv3d_wgrad_na_tf32`` on the
#: TF32 route, ``conv3d_wgrad``/``conv3d_wgrad_na`` on the CUDA-core one)
FORWARD_KEYS = {
    TENSOR_CORE: ("conv3d_same_fwd_tc", "conv3d_dgrad_tc",
                  "conv3d_same_na_fwd_tc"),
    TF32X3: ("conv3d_same_fwd_tf32", "conv3d_dgrad_tf32",
             "conv3d_same_na_fwd_tf32"),
    CUDA_CORE: ("conv3d_same_fwd", "conv3d_dgrad", "conv3d_same_na_fwd"),
}
#: the tensor-core kernels: channels a staged chunk carries, the widest
#: output-channel tile of the forward, the wgrad's (c, f) tile and its
#: voxel tile (d, h, w), and the blocks a wgrad pass aims for (4 waves of
#: one block on each of 132 SMs)
TC_CHUNK = 32
TC_MAX_BN = 128
TC_WGRAD_TILE = (32, 32)
TC_VOXEL_TILE = (4, 8, 8)
_TC_WGRAD_TARGET_BLOCKS = 528
#: the TF32 forwards: fp32 channels a staged chunk carries (64-byte rows)
#: and the floats of a packed weight row (the chunk padded to 80 bytes);
#: the TF32 wgrad's (c, f) tile (one 64-byte x halo row, two g planes of
#: 16 channels) over the voxel tiles of :data:`TC_VOXEL_TILE`
TF32_CHUNK = 16
TF32_PITCH = 20
TF32_WGRAD_TILE = (16, 32)

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


def conv3d_route(dtype: torch.dtype, C: int, F: int) -> str:
    """Which kernel family a CUDA call of :func:`conv3d_same`,
    :func:`conv3d_dgrad`, :func:`conv3d_wgrad`, :func:`conv3d_same_na` or
    :func:`conv3d_wgrad_na` with C input and F output channels launches:
    with C % 8 == 0 and F % 8 == 0 (TMA's 16-byte strides in bf16)
    :data:`TENSOR_CORE` for bf16 and :data:`TF32X3` for fp32, else
    :data:`CUDA_CORE`.  The rule
    is symmetric in C and F, so the dgrad (F -> C) takes its forward's
    route."""
    if C % 8 or F % 8 or dtype not in (torch.bfloat16, torch.float32):
        return CUDA_CORE
    return TENSOR_CORE if dtype == torch.bfloat16 else TF32X3


def tc_tile_n(F: int, max_bn: int = TC_MAX_BN) -> tuple[int, int]:
    """(BN, n_tiles): a tensor-core forward's output-channel tile, a
    multiple of 32 up to ``max_bn`` (:data:`TC_MAX_BN` for the 3^3 conv),
    and how many cover F (192 -> two of 96, 40 -> one of 64)."""
    n_tiles = -(-F // max_bn)
    per = -(-F // n_tiles)
    return -(-per // 32) * 32, n_tiles


def pack_weights_tc(w: torch.Tensor) -> torch.Tensor:
    """torch weights w[F, C, 3, 3, 3] -> the tensor-core forward's layout
    [n_tiles, C chunks, kd, kh, kw, 32, BN + 8]: for each (output tile,
    32-channel chunk, kd, kh) step one contiguous block of 3 kw taps x 32
    channels x BN output channels, rows padded by 8 values (16 bytes) so
    the kernel's ldmatrix rows fall on distinct banks.  Zeros past C, F
    and in the padding.  The plain version of the packing kernel that
    ``conv3d_same_fwd_tc`` runs first (one launch where these torch ops
    take several, the wrapper's host time at small shapes)."""
    Fo, C = w.shape[:2]
    bn, n_tiles = tc_tile_n(Fo)
    n_chunks = -(-C // TC_CHUNK)
    if (Fo, C) != (n_tiles * bn, n_chunks * TC_CHUNK):
        w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, n_chunks * TC_CHUNK - C,
                      0, n_tiles * bn - Fo))
    wp = w.new_zeros((n_tiles, n_chunks, 3, 3, 3, TC_CHUNK, bn + 8))
    wp[..., :bn] = w.view(n_tiles, bn, n_chunks, TC_CHUNK, 3, 3, 3).permute(
        0, 2, 4, 5, 6, 3, 1)
    return wp


def conv3d_same_packed_plain(x: torch.Tensor, wp: torch.Tensor,
                             F_out: int) -> torch.Tensor:
    """The tensor-core forward's arithmetic in plain PyTorch, from the
    packed weights of :func:`pack_weights_tc`: the sum over the 27 taps of
    the shifted, zero-padded x times that tap's [C, F] matrix, in fp32,
    cast once to x's dtype."""
    B, D, H, W, C = x.shape
    n_tiles, n_chunks = wp.shape[:2]
    bn = wp.shape[-1] - 8
    taps = wp[..., :bn].permute(2, 3, 4, 1, 5, 0, 6).reshape(
        3, 3, 3, n_chunks * TC_CHUNK, n_tiles * bn)[:, :, :, :C, :F_out]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    y = x.new_zeros((B, D, H, W, F_out), dtype=torch.float32)
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                y += xp[:, kd:kd + D, kh:kh + H, kw:kw + W] @ \
                    taps[kd, kh, kw].float()
    return y.to(x.dtype)


def conv3d_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv3d`` with padding 1, channels-last in and out."""
    _check(x, w)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


# ------------------------------------------------- the TF32 route (3xTF32)

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` and the kernels' ``tf32_rna``: on an
    int32 view, add half of the 13 dropped bits' range and clear them
    (infinities stay); a NaN becomes the quiet NaN 0x7FC00000, where the
    add would carry 0x7FFFFFFF into the sign bit."""
    t = t.float().contiguous()
    r = ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return r.masked_fill(t.isnan(), float("nan"))


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32(t), lo = tf32(t - hi), the error-compensated
    split of the TF32 kernels (t - hi is exact in fp32).  Where t is a NaN
    or infinite, hi carries it and lo is 0, as the kernels' ``split_tf32``
    rounds the NaN that t - hi is there."""
    t = t.float()
    hi = tf32_round(t)
    return hi, tf32_round(t - hi).masked_fill(~t.isfinite(), 0.0)


def tf32_tile_n(F: int) -> tuple[int, int]:
    """(BN, n_tiles): a TF32 forward's output-channel tile, 32 (with
    512-voxel boxes) or 64 (256-voxel boxes), whichever covers F with
    fewer padded channels (64 on a tie: fewer halo loads), and how many
    tiles cover F (96 -> three of 32, 128 -> two of 64)."""
    bn = 32 if -(-F // 32) * 32 < -(-F // 64) * 64 else 64
    return bn, -(-F // bn)


def pack_weights_tf32(w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """torch weights w[F, C, 3, 3, 3] (with ``flip``: the forward's, packed
    as ``flip_swap(w)``, the dgrad's) -> the TF32 forwards' layout
    [n_tiles, C chunks, kd, kh, part, kw, BN, 20], part 0 the TF32 hi and 1
    the lo of :func:`tf32_split`: for each (output tile, 16-channel chunk,
    kd, kh) step one contiguous block of both parts' 3 kw taps x BN output
    channels x 16 input channels, each row of 16 padded to 20 values (80
    bytes) so the kernel's ldmatrix rows fall on distinct banks.  Zeros
    past C, F and in the padding.  The plain version of the packing kernel
    that the TF32 entries run first."""
    if flip:
        w = flip_swap(w)
    Fo, C = w.shape[:2]
    bn, n_tiles = tf32_tile_n(Fo)
    n_chunks = -(-C // TF32_CHUNK)
    w = F.pad(w.float(), (0, 0, 0, 0, 0, 0, 0, n_chunks * TF32_CHUNK - C,
                          0, n_tiles * bn - Fo))
    # [n_tiles, chunks, kd, kh, kw, bn, 16]
    w = w.reshape(n_tiles, bn, n_chunks, TF32_CHUNK, 3, 3, 3).permute(
        0, 2, 4, 5, 6, 1, 3)
    wp = w.new_zeros((n_tiles, n_chunks, 3, 3, 2, 3, bn, TF32_PITCH))
    wp[..., :TF32_CHUNK] = torch.stack(tf32_split(w), dim=4)
    return wp


def conv3d_same_tf32x3_plain(x: torch.Tensor, w: torch.Tensor,
                             na=None) -> torch.Tensor:
    """The TF32 kernels' arithmetic in plain PyTorch (3xTF32): x and w each
    split into TF32 hi and lo parts (:func:`tf32_split`), then y = x_lo w_hi
    + x_hi w_lo + x_hi w_hi, three SAME convs summed in fp32 (the dropped
    x_lo w_lo is 2^-22 of x w).  ``na`` = (mean, rstd, act) splits the
    fp32 norm-act of x instead (``conv3d_same_na_fwd_tf32``).  Not on the
    card's path: the CPU tests hold it against fp64 and the Pallas
    kernels."""
    _check(x, w)
    if na is not None:
        _check_na(x, *na)
        x = _normed(x, *na)
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w)
    return (conv3d_same_plain(xl, wh) + conv3d_same_plain(xh, wl)
            + conv3d_same_plain(xh, wh))


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
    shape = (B, D, H, W, C, Fo)
    if na is None:
        _build.call("conv3d_same_fwd", x.data_ptr(), wp.data_ptr(),
                    y.data_ptr(), _backend.dtype_code(x), *shape,
                    device=x.device)
    else:
        mean, rstd, act = na
        _build.call("conv3d_same_na_fwd", x.data_ptr(), wp.data_ptr(),
                    y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                    _backend.dtype_code(x), fused_norm._act_code(act),
                    *shape, device=x.device)
    launches[key] += 1
    return y


def _launch_packed(x: torch.Tensor, w: torch.Tensor, key: str, flip, na,
                   suffix: str, bn: int, wp_numel: int) -> torch.Tensor:
    """A packing forward, ``conv3d_same_fwd_<suffix>`` (or with ``na``
    ``conv3d_same_na_fwd_<suffix>``), at output tile ``bn``, with
    ``wp_numel`` values of scratch for its packed weights."""
    if not x.is_contiguous():
        raise ValueError("kernel needs a contiguous x[B, D, H, W, C]")
    B, D, H, W, C = x.shape
    Fo = w.shape[1] if flip else w.shape[0]
    w = w.contiguous()
    wp = torch.empty(wp_numel, dtype=x.dtype, device=x.device)
    y = torch.empty((B, D, H, W, Fo), dtype=x.dtype, device=x.device)
    shape = (B, D, H, W, C, Fo, bn)
    if na is None:
        _build.call(f"conv3d_same_fwd_{suffix}", x.data_ptr(), w.data_ptr(),
                    wp.data_ptr(), y.data_ptr(), *shape, int(flip),
                    device=x.device)
    else:
        mean, rstd, act = na
        _build.call(f"conv3d_same_na_fwd_{suffix}", x.data_ptr(),
                    w.data_ptr(), wp.data_ptr(), y.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(),
                    fused_norm._act_code(act), *shape, device=x.device)
    launches[key] += 1
    return y


def packed_numel(route: str, C: int, F: int, bn: int) -> int:
    """Values of the packed-weight scratch a tensor-core (bf16, the layout
    of :func:`pack_weights_tc`) or TF32 (:func:`pack_weights_tf32`)
    forward's entry fills, for C in, F out and output tile ``bn``."""
    n_tiles = -(-F // bn)
    if route == TENSOR_CORE:
        return n_tiles * -(-C // TC_CHUNK) * 27 * TC_CHUNK * (bn + 8)
    return n_tiles * -(-C // TF32_CHUNK) * 9 * 2 * 3 * bn * TF32_PITCH


def _launch_fwd_tc(x: torch.Tensor, w: torch.Tensor, key: str,
                   flip: bool = False, na=None) -> torch.Tensor:
    """The tensor-core forward ``conv3d_same_fwd_tc`` on torch weights
    w[F, C, 3, 3, 3] or, with ``flip``, on ``flip_swap(w)`` (the input
    gradient; the entry's packing kernel applies the flip), counted under
    ``key``; ``na`` = (mean, rstd, act) selects ``conv3d_same_na_fwd_tc``.
    The entry packs the weights as :func:`pack_weights_tc` does into
    scratch the wrapper allocates."""
    Fo = w.shape[1] if flip else w.shape[0]
    bn = tc_tile_n(Fo)[0]
    return _launch_packed(x, w, key, flip, na, "tc", bn,
                          packed_numel(TENSOR_CORE, x.shape[-1], Fo, bn))


def _launch_fwd_tf32(x: torch.Tensor, w: torch.Tensor, key: str,
                     flip: bool = False, na=None) -> torch.Tensor:
    """The TF32 forward ``conv3d_same_fwd_tf32`` (fp32), as
    :func:`_launch_fwd_tc`; ``na`` selects ``conv3d_same_na_fwd_tf32``.
    The entry packs and splits the weights as :func:`pack_weights_tf32`
    does."""
    Fo = w.shape[1] if flip else w.shape[0]
    bn = tf32_tile_n(Fo)[0]
    return _launch_packed(x, w, key, flip, na, "tf32", bn,
                          packed_numel(TF32X3, x.shape[-1], Fo, bn))


def _launch_route(route: str, x: torch.Tensor, w: torch.Tensor, key: str,
                  flip: bool = False, na=None) -> torch.Tensor:
    """The forward kernel of ``route`` on torch weights w (with ``flip``:
    on ``flip_swap(w)``), counted under ``key``; ``na`` = (mean, rstd, act)
    selects the route's fused forward."""
    if route == TENSOR_CORE:
        return _launch_fwd_tc(x, w, key, flip=flip, na=na)
    if route == TF32X3:
        return _launch_fwd_tf32(x, w, key, flip=flip, na=na)
    return _launch_fwd(x, flip_swap(w) if flip else w, key, na)


def conv3d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1, zero-pad-1 3^3 correlation: x[B, D, H, W, C] with torch
    weights w[F, C, 3, 3, 3] -> y[B, D, H, W, F] in x.dtype.

    The counterpart of ``cbim_tpu.ops.pallas.conv3d.conv3d_same`` (which
    takes w as [3, 3, 3, C, F]).  CUDA tensors launch the kernel of
    :func:`conv3d_route`, CPU tensors run the plain version (the op
    ``cbim::conv3d_same``).  No autograd: see :class:`Conv3dSame`."""
    _check(x, w)
    _backend.check_device(x)
    return torch.ops.cbim.conv3d_same(x, w)


def conv3d_same_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``cbim::conv3d_same`` on the card: the forward kernel of
    :func:`conv3d_route`."""
    _backend.require_kernels(x)
    route = conv3d_route(x.dtype, x.shape[-1], w.shape[0])
    return _launch_route(route, x, w, FORWARD_KEYS[route][0])


def conv3d_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of :func:`conv3d_same`: the forward kernel of the
    same route on the upstream gradient g[B, D, H, W, F] with
    ``flip_swap(w)`` (the op ``cbim::conv3d_dgrad``)."""
    _check(g, flip_swap(w))
    _backend.check_device(g)
    return torch.ops.cbim.conv3d_dgrad(g, w)


def conv3d_dgrad_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv3d_dgrad`: ``conv3d_same_plain`` with
    ``flip_swap(w)``."""
    return conv3d_same_plain(g, flip_swap(w))


def conv3d_dgrad_cuda(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``cbim::conv3d_dgrad`` on the card: the forward kernel of the
    route on g with the flip, counted as the route's dgrad."""
    _backend.require_kernels(g)
    route = conv3d_route(g.dtype, g.shape[-1], w.shape[1])
    return _launch_route(route, g, w, FORWARD_KEYS[route][1], flip=True)


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


def voxel_tiles(B: int, D: int, H: int, W: int) -> int:
    """The tensor-core wgrad's voxel tiles: (4, 8, 8) boxes covering each
    sample, ragged ones included."""
    td, th, tw = TC_VOXEL_TILE
    return B * -(-D // td) * -(-H // th) * -(-W // tw)


def wgrad_tc_chunking(n_tiles: int, C: int, F: int, tile: tuple[int, int],
                      taps: int = 27) -> tuple[int, int]:
    """(tiles_per_chunk, n_chunks) for a tensor-core wgrad's split
    reduction over ``n_tiles`` voxel (or pixel) tiles: a block owns a chunk
    of tiles and one (c, f) ``tile`` of dW for all ``taps`` taps
    (:data:`TC_WGRAD_TILE` for ``conv3d_wgrad_tc`` and
    ``conv3d_wgrad_na_tc``, :data:`TF32_WGRAD_TILE` for
    ``conv3d_wgrad_tf32`` and, at 9 taps, the 3x3 ``conv2d_wgrad_tf32``);
    every chunk holds at least one tile and the fp32 partials stay within
    ``_WGRAD_MAX_PARTIAL_BYTES``."""
    tiles = -(-C // tile[0]) * -(-F // tile[1])
    cap = max(1, _WGRAD_MAX_PARTIAL_BYTES // (taps * C * F * 4))
    n_chunks = max(1, min(_TC_WGRAD_TARGET_BLOCKS // tiles, cap, 65535,
                          n_tiles))
    per = -(-n_tiles // n_chunks)
    return per, -(-n_tiles // per)


def conv3d_wgrad_tf32x3_plain(x: torch.Tensor, g: torch.Tensor
                              ) -> torch.Tensor:
    """``conv3d_wgrad_tf32``'s arithmetic in plain PyTorch (3xTF32): x and
    g each split into TF32 hi and lo parts (:func:`tf32_split`), then dW =
    wgrad(x_lo, g_hi) + wgrad(x_hi, g_lo) + wgrad(x_hi, g_hi), three
    weight gradients summed in fp32 (the dropped x_lo g_lo is 2^-22 of
    x g), torch's [F, C, 3, 3, 3].  Not on the card's path: the CPU tests
    hold it against fp64 and the Pallas kernel."""
    _check_wgrad(x, g)
    (xh, xl), (gh, gl) = tf32_split(x), tf32_split(g)
    return (conv3d_wgrad_plain(xl, gh) + conv3d_wgrad_plain(xh, gl)
            + conv3d_wgrad_plain(xh, gh))


def conv3d_wgrad_na_tf32x3_plain(x: torch.Tensor, mean: torch.Tensor,
                                 rstd: torch.Tensor, g: torch.Tensor,
                                 act=None) -> torch.Tensor:
    """``conv3d_wgrad_na_tf32``'s arithmetic in plain PyTorch: the fp32
    norm-act of x (``inorm_apply_plain``; SAME padding of the normalised
    input), then :func:`conv3d_wgrad_tf32x3_plain` of it and g.  Not on the
    card's path: the CPU tests hold it against fp64 and the Pallas
    kernel."""
    _check_wgrad(x, g)
    _check_na(x, mean, rstd, act)
    return conv3d_wgrad_tf32x3_plain(_normed(x, mean, rstd, act), g)


def _launch_wgrad_tf32(x: torch.Tensor, g: torch.Tensor,
                       na=None) -> torch.Tensor:
    """The 3xTF32 wgrad ``conv3d_wgrad_tf32`` (fp32) and its fold; ``na``
    = (mean, rstd, act) selects ``conv3d_wgrad_na_tf32``."""
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("kernel needs contiguous x and g")
    B, D, H, W, C = x.shape
    Fo = g.shape[-1]
    per, n_chunks = wgrad_tc_chunking(voxel_tiles(B, D, H, W), C, Fo,
                                      TF32_WGRAD_TILE)
    partial = torch.empty(n_chunks * 27 * C * Fo, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((3, 3, 3, C, Fo), dtype=torch.float32, device=x.device)
    shape = (B, D, H, W, C, Fo, per, n_chunks)
    if na is None:
        _build.call("conv3d_wgrad_tf32", x.data_ptr(), g.data_ptr(),
                    partial.data_ptr(), dw.data_ptr(), *shape,
                    device=x.device)
    else:
        mean, rstd, act = na
        _build.call("conv3d_wgrad_na_tf32", x.data_ptr(), g.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(),
                    dw.data_ptr(), fused_norm._act_code(act), *shape,
                    device=x.device)
    launches["conv3d_wgrad_tf32" if na is None
             else "conv3d_wgrad_na_tf32"] += 1
    return dw.permute(4, 3, 0, 1, 2)


def _launch_wgrad_tc(x: torch.Tensor, g: torch.Tensor,
                     na=None) -> torch.Tensor:
    """The tensor-core wgrad ``conv3d_wgrad_tc`` and its fold; ``na`` =
    (mean, rstd, act) selects ``conv3d_wgrad_na_tc``."""
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("kernel needs contiguous x and g")
    B, D, H, W, C = x.shape
    Fo = g.shape[-1]
    per, n_chunks = wgrad_tc_chunking(voxel_tiles(B, D, H, W), C, Fo,
                                      TC_WGRAD_TILE)
    partial = torch.empty(n_chunks * 27 * C * Fo, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((3, 3, 3, C, Fo), dtype=torch.float32, device=x.device)
    shape = (B, D, H, W, C, Fo, per, n_chunks)
    if na is None:
        _build.call("conv3d_wgrad_tc", x.data_ptr(), g.data_ptr(),
                    partial.data_ptr(), dw.data_ptr(), *shape,
                    device=x.device)
    else:
        mean, rstd, act = na
        _build.call("conv3d_wgrad_na_tc", x.data_ptr(), g.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(),
                    dw.data_ptr(), fused_norm._act_code(act), *shape,
                    device=x.device)
    launches["conv3d_wgrad_tc" if na is None else "conv3d_wgrad_na_tc"] += 1
    return dw.permute(4, 3, 0, 1, 2)


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
    shape = (B, D, H, W, C, Fo, rows, n_chunks)
    if na is None:
        _build.call("conv3d_wgrad", x.data_ptr(), g.data_ptr(),
                    partial.data_ptr(), dw.data_ptr(), _backend.dtype_code(x),
                    *shape, device=x.device)
    else:
        mean, rstd, act = na
        _build.call("conv3d_wgrad_na", x.data_ptr(), g.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(),
                    dw.data_ptr(), _backend.dtype_code(x),
                    fused_norm._act_code(act), *shape, device=x.device)
    launches["conv3d_wgrad" if na is None else "conv3d_wgrad_na"] += 1
    return dw.permute(4, 3, 0, 1, 2)


def conv3d_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of :func:`conv3d_same`: x[B, D, H, W, C],
    g[B, D, H, W, F] -> dW[F, C, 3, 3, 3] float32 (torch's layout).

    The counterpart of ``cbim_tpu.ops.pallas.conv3d.conv3d_wgrad`` (which
    returns [3, 3, 3, C, F]).  CUDA tensors launch the kernel of
    :func:`conv3d_route` (``conv3d_wgrad_tc`` on the bf16 tensor-core
    route, ``conv3d_wgrad_tf32`` on the fp32 TF32 route, ``conv3d_wgrad``
    on the CUDA-core one), CPU tensors run the plain version (the op
    ``cbim::conv3d_wgrad``).  On either device dW is a view of a [3, 3, 3,
    C, F] tensor, the kernels' output."""
    _check_wgrad(x, g)
    _backend.check_device(x)
    return torch.ops.cbim.conv3d_wgrad(x, g)


def conv3d_wgrad_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``cbim::conv3d_wgrad`` on the card: the wgrad of
    :func:`conv3d_route`."""
    _backend.require_kernels(x)
    route = conv3d_route(x.dtype, x.shape[-1], g.shape[-1])
    if route == TENSOR_CORE:
        return _launch_wgrad_tc(x, g)
    if route == TF32X3:
        return _launch_wgrad_tf32(x, g)
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
    the kernel of :func:`conv3d_route` (``conv3d_same_na_fwd_tc``,
    ``conv3d_same_na_fwd_tf32`` or ``conv3d_same_na_fwd``), CPU tensors
    run the plain version (the op ``cbim::conv3d_same_na``, which takes
    act as its ``fused_norm.ACT_NAMES`` code)."""
    _check(x, w)
    _check_na(x, mean, rstd, act)
    _backend.check_device(x)
    return torch.ops.cbim.conv3d_same_na(x, mean, rstd, w,
                                         fused_norm._act_code(act))


def conv3d_same_na_cuda(x: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor, w: torch.Tensor,
                        act=None) -> torch.Tensor:
    """``cbim::conv3d_same_na`` on the card: the fused forward of
    :func:`conv3d_route`."""
    _backend.require_kernels(x)
    route = conv3d_route(x.dtype, x.shape[-1], w.shape[0])
    return _launch_route(route, x, w, FORWARD_KEYS[route][2],
                         na=(mean, rstd, act))


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
    CUDA tensors launch the kernel of :func:`conv3d_route`
    (``conv3d_wgrad_na_tc`` on the bf16 tensor-core route,
    ``conv3d_wgrad_na_tf32`` on the fp32 TF32 route, ``conv3d_wgrad_na`` on
    the CUDA-core one), CPU tensors run the plain version (the op
    ``cbim::conv3d_wgrad_na``)."""
    _check_wgrad(x, g)
    _check_na(x, mean, rstd, act)
    _backend.check_device(x)
    return torch.ops.cbim.conv3d_wgrad_na(x, mean, rstd, g,
                                          fused_norm._act_code(act))


def conv3d_wgrad_na_cuda(x: torch.Tensor, mean: torch.Tensor,
                         rstd: torch.Tensor, g: torch.Tensor,
                         act=None) -> torch.Tensor:
    """``cbim::conv3d_wgrad_na`` on the card: the fused wgrad of
    :func:`conv3d_route`."""
    _backend.require_kernels(x)
    route = conv3d_route(x.dtype, x.shape[-1], g.shape[-1])
    if route == TENSOR_CORE:
        return _launch_wgrad_tc(x, g, (mean, rstd, act))
    if route == TF32X3:
        return _launch_wgrad_tf32(x, g, (mean, rstd, act))
    return _launch_wgrad(x, g, (mean, rstd, act))


def na_tc_box(F: int) -> tuple[int, int, int]:
    """``conv3d_same_na_fwd_tc``'s output box (d, h, w) for F output
    channels: 512 voxels at F tiles of up to 64 channels, 256 at 96 or
    128."""
    return (4, 8, 16) if tc_tile_n(F)[0] <= 64 else (4, 8, 8)


def _na_halo(x, inside, mean, rstd, act, box, at) -> torch.Tensor:
    """A staged halo of the fused tensor-core kernels in plain PyTorch: the
    box (d, h, w) + 2 at voxel ``at`` of x (padded as TMA sees it: zeros
    past the volume and past C), the norm-act in x's dtype on the rows
    ``inside`` the volume and the channels whose ``mean`` and ``rstd`` are
    given (zero padded past C), zeros elsewhere; fp32."""
    (z0, y0, x0), (td, th, tw) = at, box
    halo = x[:, z0:z0 + td + 2, y0:y0 + th + 2, x0:x0 + tw + 2]
    keep = inside[z0:z0 + td + 2, y0:y0 + th + 2, x0:x0 + tw + 2, None]
    hn = fused_norm.inorm_apply_plain(halo.reshape(halo.shape[0], -1,
                                                   halo.shape[-1]),
                                      mean, rstd, act).view(halo.shape)
    return torch.where(keep, hn.float(), 0.0)


def _na_padded(x, mean, rstd, box):
    """(x, inside, mean, rstd) for :func:`_na_halo`: x with one voxel of
    zeros before the volume, zeros after it up to whole boxes plus one, and
    channels up to a multiple of 32; ``inside`` the volume's mask in that
    frame; the statistics zero past C."""
    B, D, H, W, C = x.shape
    (td, th, tw), cp = box, -(-C // TC_CHUNK) * TC_CHUNK
    pad = (1, -(-W // tw) * tw + 1 - W, 1, -(-H // th) * th + 1 - H,
           1, -(-D // td) * td + 1 - D)
    inside = F.pad(torch.ones((D, H, W), dtype=torch.bool, device=x.device),
                   pad)
    return (F.pad(x, (0, cp - C) + pad), inside, F.pad(mean, (0, cp - C)),
            F.pad(rstd, (0, cp - C)))


def conv3d_same_na_tiled_plain(x: torch.Tensor, mean: torch.Tensor,
                               rstd: torch.Tensor, w: torch.Tensor,
                               act=None) -> torch.Tensor:
    """``conv3d_same_na_fwd_tc``'s decomposition in plain PyTorch: for each
    output box of :func:`na_tc_box`, the halo box as TMA stages it (raw x,
    zeros outside the volume and past C), the norm-act on the rows inside
    the volume only, rounded to x's dtype, then the 27 taps of the packed
    weights (:func:`pack_weights_tc`) in fp32; y rounded once to x's
    dtype."""
    _check(x, w)
    _check_na(x, mean, rstd, act)
    B, D, H, W, C = x.shape
    Fo = w.shape[0]
    box = td, th, tw = na_tc_box(Fo)
    wp = pack_weights_tc(w)
    n_tiles, n_chunks = wp.shape[:2]
    bn = wp.shape[-1] - 8
    taps = wp[..., :bn].permute(2, 3, 4, 1, 5, 0, 6).reshape(
        3, 3, 3, n_chunks * TC_CHUNK, n_tiles * bn)[..., :Fo].float()
    xp, inside, mp, rp = _na_padded(x, mean, rstd, box)
    y = torch.zeros((B, *(s - 2 for s in xp.shape[1:4]), Fo),
                    device=x.device)
    for z0 in range(0, y.shape[1], td):
        for y0 in range(0, y.shape[2], th):
            for x0 in range(0, y.shape[3], tw):
                hn = _na_halo(xp, inside, mp, rp, act, box, (z0, y0, x0))
                out = y[:, z0:z0 + td, y0:y0 + th, x0:x0 + tw]
                for kd in range(3):
                    for kh in range(3):
                        for kw in range(3):
                            out += hn[:, kd:kd + td, kh:kh + th,
                                      kw:kw + tw] @ taps[kd, kh, kw]
    return y[:, :D, :H, :W].to(x.dtype)


def conv3d_wgrad_na_tiled_plain(x: torch.Tensor, mean: torch.Tensor,
                                rstd: torch.Tensor, g: torch.Tensor,
                                act=None) -> torch.Tensor:
    """``conv3d_wgrad_na_tc``'s decomposition in plain PyTorch: the voxel
    tiles of :data:`TC_VOXEL_TILE` in (b, d, h, w) order, cut into the
    chunks of :func:`wgrad_tc_chunking`; per tile the x halo as the forward
    stages it (:func:`conv3d_same_na_tiled_plain`) and the g tile (zeros
    past the volume); per chunk the fp32 partial sums of the 27 taps'
    X_t^T G, folded in chunk order -> dW[F, C, 3, 3, 3]."""
    _check_wgrad(x, g)
    _check_na(x, mean, rstd, act)
    B, D, H, W, C = x.shape
    Fo = g.shape[-1]
    box = td, th, tw = TC_VOXEL_TILE
    xp, inside, mp, rp = _na_padded(x, mean, rstd, box)
    gp = F.pad(g, (0, 0, 0, xp.shape[3] - 2 - W, 0, xp.shape[2] - 2 - H,
                   0, xp.shape[1] - 2 - D))
    per, _ = wgrad_tc_chunking(voxel_tiles(B, D, H, W), C, Fo, TC_WGRAD_TILE)
    cp = xp.shape[-1]
    dw = torch.zeros((3, 3, 3, cp, Fo), device=x.device)
    part = torch.zeros_like(dw)
    n = 0
    for b in range(B):
        for z0 in range(0, gp.shape[1], td):
            for y0 in range(0, gp.shape[2], th):
                for x0 in range(0, gp.shape[3], tw):
                    hn = _na_halo(xp[b:b + 1], inside, mp[b:b + 1],
                                  rp[b:b + 1], act, box, (z0, y0, x0))[0]
                    gt = gp[b, z0:z0 + td, y0:y0 + th, x0:x0 + tw].float()
                    gt = gt.reshape(-1, Fo)
                    for kd in range(3):
                        for kh in range(3):
                            for kw in range(3):
                                part[kd, kh, kw] += hn[
                                    kd:kd + td, kh:kh + th,
                                    kw:kw + tw].reshape(-1, cp).T @ gt
                    n += 1
                    if n % per == 0:
                        dw += part
                        part.zero_()
    dw += part
    return dw[:, :, :, :C].permute(4, 3, 0, 1, 2)


class Conv3dSame(torch.autograd.Function):
    """Trainable :func:`conv3d_same` (the counterpart of ``conv3d_same_t``).

    Forward: :func:`conv3d_same`.  Backward: dx by :func:`conv3d_dgrad`, dW
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


class SpatialConvInormAct3d(torch.autograd.Function):
    """:class:`ConvInormAct3d` of one H slab of a volume sharded over the
    process ``group`` (``parallel.spatial``),
    ``SpatialConvInormAct3d.apply(x, w, eps, act, group)`` over a
    channels-last slab x[B, D, H, W, C]: the unsharded fused conv's output
    on the slab's rows, on the same kernels.

    Forward: the slab's ``inorm_stats`` merged over the group
    (``fused_norm.merge_stats``); the raw slab with one plane of each
    neighbour (``spatial.exchange``; none at the volume's ends, where the
    kernel's zero padding of the normalised input is the unsharded one);
    :func:`conv3d_same_na` of it, the halo rows of its output dropped.
    Backward: the upstream gradient zero-padded over the halo rows; dW =
    :func:`conv3d_wgrad_na` on the haloed slab; the normalised input's
    gradient :func:`conv3d_dgrad` over the haloed rows, its halo rows added
    into the neighbours' (``spatial.exchange_transpose``); dx by the norm
    backward with the group's sums (``fused_norm._spatial_backward``).
    Saves the haloed slab, never the normalised tensor."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, w, eps, act, group):
        _check(x, w)
        mean, rstd = fused_norm.merge_stats(
            *fused_norm._stats(fused_norm._rows(x), eps), eps, group)
        xh, pre, post = spatial.exchange(x, 1, group, 2)
        ctx.save_for_backward(xh, w, mean, rstd)
        ctx.act, ctx.group, ctx.pre, ctx.post = act, group, pre, post
        y = conv3d_same_na(xh, mean, rstd, w, act)
        return y.narrow(2, pre, x.shape[2]).contiguous()

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        xh, w, mean, rstd = ctx.saved_tensors
        pre, post = ctx.pre, ctx.post
        n = xh.shape[2] - pre - post
        gh = g.new_zeros((*xh.shape[:-1], g.shape[-1]), dtype=xh.dtype)
        gh.narrow(2, pre, n).copy_(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxn = spatial.exchange_transpose(conv3d_dgrad(gh, w), pre, post,
                                             1, ctx.group, 2)
            x = xh.narrow(2, pre, n).contiguous()
            dx = fused_norm._spatial_backward(
                fused_norm._rows(x), fused_norm._rows(dxn.contiguous()),
                mean, rstd, ctx.act, ctx.group).view(x.shape)
        if ctx.needs_input_grad[1]:
            dw = conv3d_wgrad_na(xh, mean, rstd, gh, ctx.act).to(w.dtype)
        return dx, dw, None, None, None


# ------------------------------------------------------------ the custom ops

def _same_fake(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[0]))


def _dgrad_fake(g, w):
    return g.new_empty((*g.shape[:-1], w.shape[1]))


def _wgrad_fake(x, g):
    """dW[F, C, 3, 3, 3] float32 as the kernels give it on either device: a
    view of a [3, 3, 3, C, F] tensor."""
    return x.new_empty((3, 3, 3, x.shape[-1], g.shape[-1]),
                       dtype=torch.float32).permute(4, 3, 0, 1, 2)


def _wgrad_cpu(x, g):
    """The plain version in the kernels' layout of dW."""
    return _wgrad_fake(x, g).copy_(conv3d_wgrad_plain(x, g))


def _same_na_cpu(x, mean, rstd, w, act):
    return conv3d_same_na_plain(x, mean, rstd, w, fused_norm.ACT_NAMES[act])


def _same_na_cuda(x, mean, rstd, w, act):
    return conv3d_same_na_cuda(x, mean, rstd, w, fused_norm.ACT_NAMES[act])


def _same_na_fake(x, mean, rstd, w, act):
    return _same_fake(x, w)


def _wgrad_na_cpu(x, mean, rstd, g, act):
    return _wgrad_fake(x, g).copy_(conv3d_wgrad_na_plain(
        x, mean, rstd, g, fused_norm.ACT_NAMES[act]))


def _wgrad_na_cuda(x, mean, rstd, g, act):
    return conv3d_wgrad_na_cuda(x, mean, rstd, g, fused_norm.ACT_NAMES[act])


def _wgrad_na_fake(x, mean, rstd, g, act):
    return _wgrad_fake(x, g)


_library.define("conv3d_same", "(Tensor x, Tensor w) -> Tensor",
                conv3d_same_plain, conv3d_same_cuda, _same_fake)
_library.define("conv3d_dgrad", "(Tensor g, Tensor w) -> Tensor",
                conv3d_dgrad_plain, conv3d_dgrad_cuda, _dgrad_fake)
_library.define("conv3d_wgrad", "(Tensor x, Tensor g) -> Tensor",
                _wgrad_cpu, conv3d_wgrad_cuda, _wgrad_fake)
_library.define("conv3d_same_na", "(Tensor x, Tensor mean, Tensor rstd, "
                "Tensor w, int act) -> Tensor",
                _same_na_cpu, _same_na_cuda, _same_na_fake)
_library.define("conv3d_wgrad_na", "(Tensor x, Tensor mean, Tensor rstd, "
                "Tensor g, int act) -> Tensor",
                _wgrad_na_cpu, _wgrad_na_cuda, _wgrad_na_fake)
