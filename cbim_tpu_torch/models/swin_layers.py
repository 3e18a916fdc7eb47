"""Shifted-window attention machinery of the Swin family (counterpart of
``cbim_tpu/models/swin_layers.py``), with MONAI's parameter names.

Token stages work channels-last, (B, *spatial, C): the models hand them
``x.permute(0, 2, 3, 4, 1)`` of an NCDHW tensor in ``channels_last_3d``
memory, a view that copies nothing.  Window partitioning is reshape and
permute; the relative-position index and the shifted-window region ids are
numpy, built on the host once per padded shape and cached on the device.

A window attention takes one of two routes, by the module's mode.  In eval
mode (serving, and validation of the EMA model under ``inference_mode``)
it goes through ``ops.kernels.window_attention`` (the CUDA kernel on the
card, its plain version on the CPU), which takes the shift mask as region
ids.  In training mode it is :func:`window_attention_train`, the JAX
package's XLA path (einsum, bias, the -100 mask, fp32 softmax, einsum)
under autograd: the kernel has no backward, nor has the TPU kernel it
ports, and the JAX package trains every Swin model that way.
:func:`compute_attn_mask` (the JAX package's -100 matrix) is kept for the
tests, which hold it against the region ids.

Ported: ``window_partition``/``window_reverse``, ``get_window_size``,
``relative_position_index``, ``compute_attn_mask``, ``WindowAttention``,
``SwinBlock``, ``PatchMergingLegacy`` (3D and 2D), ``PatchMergingV2`` (no
caller, as in the JAX package); ``DropPath`` (stochastic depth, drawn
from the train state's generator) and ``drop_path`` are
``layers.convs``'s, re-exported here.  Attention and projection dropout are
not: the ported recipes run without them.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import gelu
from ..ops.kernels.window_attention import region_mask, window_attention
from .layers.convs import DropPath, drop_path  # noqa: F401 (re-exported)


def window_partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, *spatial, C) -> (num_windows * B, prod(window), C), batch-major."""
    nd = x.dim() - 2
    B, C = x.shape[0], x.shape[-1]
    shape = [B]
    for i in range(nd):
        shape += [x.shape[1 + i] // window[i], window[i]]
    x = x.reshape(*shape, C)
    perm = [0, *range(1, 2 * nd, 2), *range(2, 2 * nd + 1, 2), x.dim() - 1]
    return x.permute(*perm).reshape(-1, math.prod(window), C)


def window_reverse(windows: torch.Tensor, window: Sequence[int],
                   spatial: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    nd = len(window)
    C = windows.shape[-1]
    grid = [s // w for s, w in zip(spatial, window)]
    x = windows.reshape(-1, *grid, *window, C)
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    return x.permute(*perm, x.dim() - 1).reshape(-1, *spatial, C)


def get_window_size(x_size, window_size, shift_size=None):
    """Shrink windows to the input extent; no shift along a shrunk axis."""
    use_w = list(window_size)
    use_s = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_w[i] = x_size[i]
            if use_s is not None:
                use_s[i] = 0
    if shift_size is None:
        return tuple(use_w)
    return tuple(use_w), tuple(use_s)


def relative_position_index(window: Sequence[int]) -> np.ndarray:
    """(N, N) index of each (query, key) pair's relative offset into the
    bias table of ``prod(2w - 1)`` rows."""
    coords = np.stack(np.meshgrid(*[np.arange(w) for w in window],
                                  indexing="ij"))
    flat = coords.reshape(len(window), -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    for i, w in enumerate(window):
        rel[:, :, i] += w - 1
    mult = 1
    idx = np.zeros(rel.shape[:2], np.int64)
    for i in reversed(range(len(window))):
        idx += rel[:, :, i] * mult
        mult *= 2 * window[i] - 1
    return idx


def compute_region_ids(spatial, window, shift) -> np.ndarray | None:
    """The region of every token of each window under a cyclic shift,
    int32 (num_windows, prod(window)); None when no axis is shifted.

    The labelling of the reference's shifted-window mask: each axis splits
    into [0, -w), [-w, -s), [-s, end) (one region where s = 0), and regions
    are numbered over the product of the splits."""
    if not any(s > 0 for s in shift):
        return None
    img = np.zeros(tuple(spatial), np.int32)
    ranges = []
    for w, s in zip(window, shift):
        # s == 0: slice(-w, 0) is empty and slice(None) the whole axis
        ranges.append((slice(-w),
                       slice(-w, -s) if s > 0 else slice(-w, 0),
                       slice(-s, None) if s > 0 else slice(None)))
    for cnt, idxs in enumerate(itertools.product(*ranges)):
        img[idxs] = cnt
    nd = len(spatial)
    shape, perm_a, perm_b = [], [], []
    for i in range(nd):
        shape += [spatial[i] // window[i], window[i]]
        perm_a.append(2 * i)
        perm_b.append(2 * i + 1)
    ids = img.reshape(shape).transpose(*perm_a, *perm_b)
    return np.ascontiguousarray(ids.reshape(-1, math.prod(window)))


def compute_attn_mask(spatial, window, shift) -> np.ndarray | None:
    """The shifted-window mask, (num_windows, N, N) float32 of 0 / -100, or
    None when no axis is shifted (``cbim_tpu``'s, from the region ids)."""
    ids = compute_region_ids(spatial, window, shift)
    if ids is None:
        return None
    return region_mask(torch.from_numpy(ids)).numpy()


def window_attention_train(q, k, v, rel_bias, region=None) -> torch.Tensor:
    """The training route of the window attention, the JAX package's XLA
    path (``cbim_tpu/models/swin_layers.py`` ``WindowAttention``):
    softmax(q k^T D^-1/2 + rel_bias - 100 [region_i != region_j]) v with
    the scores and the softmax in fp32, the weights cast back to v's dtype
    for the second einsum, all under autograd.  q, k, v: (B, H, N, D);
    rel_bias (H, N, N); region int32 (nW, N) or None, window b % nW.  The
    adds run in place on the fresh scores, so the forward holds one (B, H,
    N, N) tensor beside the softmax's output, which autograd keeps."""
    B, H, N, D = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q * D ** -0.5, k).float()
    s += rel_bias.float()
    if region is not None:
        nW = region.shape[0]
        s.view(B // nW, nW, H, N, N).add_(region_mask(region)[None, :, None])
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p, v)


def attend(training: bool, q, k, v, rel_bias, region) -> torch.Tensor:
    """The window attention of a module in training mode (``training``:
    :func:`window_attention_train`) or in eval mode (the kernel)."""
    fn = window_attention_train if training else window_attention
    return fn(q, k, v, rel_bias, region)


class WindowAttention(nn.Module):
    """W-MSA with relative position bias (MONAI names ``qkv``, ``proj``,
    ``relative_position_bias_table``).

    ``table_window``: the nominal window the bias table is sized for.  When
    the runtime window shrinks to the input extent, the index is sliced
    ``[:N, :N]``, as the reference does.  The index is a non-persistent
    buffer: the reference's state_dicts carry it, but it is deterministic,
    and ``import_swin_unetr`` does not read it."""

    def __init__(self, dim: int, num_heads: int, table_window: Sequence[int]):
        super().__init__()
        self.num_heads = num_heads
        table_size = math.prod(2 * w - 1 for w in table_window)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_size, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(table_window)),
            persistent=False)
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                region: torch.Tensor | None = None) -> torch.Tensor:
        """x: (windows, N, C); region: int32 (num_windows, N) or None.  The
        kernel in eval mode, :func:`window_attention_train` in training
        mode."""
        b, n, c = x.shape
        q, k, v = self.qkv_views(x)
        out = self.attend(q, k, v, self.rel_bias(n), region)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))

    def qkv_views(self, x: torch.Tensor):
        """(b, n, 3, h, hd) -> three (b, h, n, hd) views of one tensor."""
        b, n, c = x.shape
        h = self.num_heads
        return self.qkv(x).view(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)

    def rel_bias(self, n: int) -> torch.Tensor:
        """The (h, n, n) relative-position bias of an n-token window."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        return self.relative_position_bias_table[idx].view(
            n, n, self.num_heads).permute(2, 0, 1)

    def attend(self, q, k, v, rel_bias, region):
        """The route of the module's mode (:func:`attend`)."""
        return attend(self.training, q, k, v, rel_bias, region)


class Mlp(nn.Module):
    """MONAI's MLPBlock, 4x wide: ``linear1``, exact GELU, ``linear2``."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, 4 * dim)
        self.linear2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.linear2(gelu(self.linear1(x)))


class SwinMlp(nn.Module):
    """The official Swin's Mlp, 4x wide: ``fc1``, exact GELU, ``fc2``
    (VT-UNet, nnFormer and SwinUnet name it so)."""

    def __init__(self, dim: int, ratio: float = 4.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, int(dim * ratio))
        self.fc2 = nn.Linear(int(dim * ratio), dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class ShiftedWindows(nn.Module):
    """The window plumbing of the Swin blocks on (B, *spatial, C): zero
    padding to whole windows (the padded tokens are attended to, not
    masked, as in the reference), the cyclic shift, the partition and the
    region ids of the shifted windows (cached per padded shape and device),
    and the way back.  The window shrinks to the input extent, with no
    shift along a shrunk axis (:func:`get_window_size`); a subclass may
    give its own rule (:meth:`window_shift`)."""

    def __init__(self, window_size: Sequence[int], shift_size: Sequence[int]):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self._regions: dict = {}

    def _region(self, padded, window, shift, device):
        """The region ids of this padded shape on ``device`` (cached)."""
        key = (padded, window, shift, device)
        if key not in self._regions:
            ids = compute_region_ids(padded, window, shift)
            self._regions[key] = (None if ids is None
                                  else torch.from_numpy(ids).to(device))
        return self._regions[key]

    def window_shift(self, spatial):
        """The (window, shift) of a token grid of extent ``spatial``."""
        return get_window_size(spatial, self.window_size, self.shift_size)

    def partition(self, h: torch.Tensor):
        """h -> (windows (num_windows * B, N, C), region ids or None, the
        layout that :meth:`unpartition` undoes)."""
        spatial = tuple(h.shape[1:-1])
        window, shift = self.window_shift(spatial)
        pads = [(-s) % w for s, w in zip(spatial, window)]
        if any(pads):
            # F.pad orders its pairs from the last axis (C) backwards
            h = F.pad(h, [0, 0, *(p for pad in reversed(pads)
                                  for p in (0, pad))])
        padded = tuple(h.shape[1:-1])
        if any(shift):
            h = torch.roll(h, [-s for s in shift],
                           dims=tuple(range(1, 1 + len(spatial))))
        region = self._region(padded, window, shift, h.device)
        return (window_partition(h, window), region,
                (spatial, padded, window, shift))

    @staticmethod
    def unpartition(wins: torch.Tensor, layout) -> torch.Tensor:
        spatial, padded, window, shift = layout
        h = window_reverse(wins, window, padded)
        if any(shift):
            h = torch.roll(h, list(shift),
                           dims=tuple(range(1, 1 + len(spatial))))
        if padded != spatial:
            h = h[(slice(None), *(slice(0, s) for s in spatial))]
        return h


class SwinBlock(ShiftedWindows):
    """One (shifted-)window transformer block on (B, *spatial, C):
    ``norm1``, ``attn``, ``norm2``, ``mlp`` (MONAI's :class:`Mlp`, or the
    official Swin's :class:`SwinMlp`); padding after ``norm1``; one
    ``DropPath`` (a fresh draw each) on both residuals."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int],
                 shift_size: Sequence[int], drop_path: float = 0.0,
                 mlp: type = Mlp):
        super().__init__(window_size, shift_size)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, self.window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = mlp(dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wins, region, layout = self.partition(self.norm1(x))
        x = x + self.drop_path(self.unpartition(self.attn(wins, region),
                                                layout))
        return x + self.drop_path(self.mlp(self.norm2(x)))


def _pad_even(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad each odd spatial extent of (B, *spatial, C) by one."""
    pads = [s % 2 for s in x.shape[1:-1]]
    if any(pads):
        # F.pad orders its pairs from the last axis (C) backwards
        x = F.pad(x, [0, 0, *(p for pad in reversed(pads) for p in (0, pad))])
    return x


class PatchMergingLegacy(nn.Module):
    """MONAI v0.9.0 'merging' on (B, D, H, W, C) or (B, H, W, C): ``norm``,
    ``reduction`` to twice the width.  In 3D with its duplicate-slice quirk
    (the 5th and 6th slices repeat the 2nd and 3rd; (1, 1, 0) and (0, 1, 1)
    are skipped); in 2D the four (h, w) parities in the reference's order
    (0, 0), (1, 0), (0, 1), (1, 1).  Odd extents are zero-padded by one."""

    OFFSETS = {3: ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                   (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1)),
               2: ((0, 0), (1, 0), (0, 1), (1, 1))}

    def __init__(self, dim: int, spatial_dims: int = 3):
        super().__init__()
        self.offsets = self.OFFSETS[spatial_dims]
        n = len(self.offsets)
        self.norm = nn.LayerNorm(n * dim, eps=1e-5)
        self.reduction = nn.Linear(n * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad_even(x)
        x = torch.cat([x[(slice(None), *(slice(o, None, 2) for o in offs))]
                       for offs in self.offsets], dim=-1)
        return self.reduction(self.norm(x))


class PatchMergingV2(PatchMergingLegacy):
    """MONAI's corrected merging (every one of the 2^nd parities, in
    ``itertools.product`` order): ``norm``, ``reduction``.  No model of the
    port or of the JAX package builds it."""

    def __init__(self, dim: int, spatial_dims: int = 3):
        super().__init__(dim, spatial_dims)
        self.offsets = tuple(itertools.product(range(2), repeat=spatial_dims))
