"""Linear resize with ``align_corners=True`` and nearest-neighbour resize
(counterpart of ``cbim_tpu/ops/interpolate.py``).

The reference decoder upsamples with ``F.interpolate(mode='trilinear',
align_corners=True)``; ``cbim_tpu`` re-derives that rule for XLA.  Here the
PyTorch op is the rule itself.  ``resize_nearest`` keeps the JAX package's
own index rule (floor of ``j * in / out`` in fp32, clamped), axis by axis.

``group``: x is one H slab of a tensor sharded over the ranks of the
process group (``parallel.spatial``; H is the second-to-last axis), and
``out_spatial`` the output slab's shape.  Each output row's source is then
computed in the whole tensor's coordinates; a linear row whose source pair
straddles a slab boundary reads one plane of the neighbour (a halo of 1,
enough for any upsampling, the decoders' only resize across H).  The H
pass runs first, as the JAX package's separable passes (in fp32, its lerp
rule), the other axes after it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import spatial

_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


def resize_linear(x: torch.Tensor, out_spatial, group=None) -> torch.Tensor:
    """Resize x (B, C, *spatial) to ``out_spatial``, align_corners=True;
    with ``group``, an H slab to its output slab (module docstring)."""
    out_spatial = tuple(int(s) for s in out_spatial)
    if group is not None and x.shape[-2] != out_spatial[-2]:
        x = _resize_h_linear(x, out_spatial[-2], group)
    if tuple(x.shape[2:]) == out_spatial:
        return x
    return F.interpolate(x, size=out_spatial, mode=_MODES[len(out_spatial)],
                         align_corners=True)


def _global_rows(n_in: int, n_out: int, group, dtype=torch.float32
                 ) -> tuple[int, int, torch.Tensor]:
    """(slab index, slab count, this slab's output rows in the whole
    tensor's coordinates as ``dtype``) for an H axis of ``n_in`` ->
    ``n_out`` rows a slab."""
    j, s = spatial.rank_and_size(group)
    rows = torch.arange(j * n_out, (j + 1) * n_out, dtype=dtype)
    return j, s, rows


def _resize_h_linear(x: torch.Tensor, n_out: int, group) -> torch.Tensor:
    """The align_corners=True linear pass along H of an H slab, in the
    whole tensor's coordinates: position i (in - 1) / (out - 1), its pair
    of rows floor(pos) and the next (clamped as the JAX package clamps),
    positions, weights and the lerp in fp32 (fp64 for an fp64 x)."""
    dim, n_in = x.dim() - 2, x.shape[-2]
    dt = torch.promote_types(x.dtype, torch.float32)
    j, s, rows = _global_rows(n_in, n_out, group, dt)
    if n_out < n_in:
        raise NotImplementedError(
            f"a linear resize of an H slab from {n_in} to {n_out} rows: only "
            "upsampling reads no more than one neighbouring plane")
    total_in, total_out = n_in * s, n_out * s
    pos = rows * float(total_in - 1) / float(total_out - 1)
    i0 = torch.floor(pos).clamp_(0, total_in - 2)
    w = (pos - i0).to(x.device)
    xh, pre = spatial.halo(x, 1, group)
    local = i0.long() - j * n_in + pre
    if int(local.min()) < 0 or int(local.max()) + 1 >= xh.shape[dim]:
        raise ValueError("a resize's source row lies beyond the halo")
    local = local.to(x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    w = w.view(shape)
    a = xh.index_select(dim, local).to(dt)
    b = xh.index_select(dim, local + 1).to(dt)
    return (a * (1.0 - w) + b * w).to(x.dtype)


def resize_nearest(x: torch.Tensor, out_spatial, group=None) -> torch.Tensor:
    """Resize x (B, C, *spatial) to ``out_spatial`` by nearest neighbour:
    output index j of an axis reads input floor(j * in / out), computed in
    fp32 and clamped to the axis, as ``cbim_tpu``'s ``resize_nearest``
    (torch's 'nearest' rule); an axis already at its size is left alone.
    With ``group``, x is an H slab: its rows' sources, in the whole
    tensor's coordinates, lie in the slab itself when each slab's row
    counts are equal (module docstring)."""
    for i, size in enumerate(int(s) for s in out_spatial):
        axis, n = 2 + i, x.shape[2 + i]
        if n == size:
            continue
        if group is not None and axis == x.dim() - 2:
            j, s, pos = _global_rows(n, size, group)
            idx = torch.floor(pos * (n * s) / (size * s)).long() \
                .clamp_(0, n * s - 1) - j * n
            if int(idx.min()) < 0 or int(idx.max()) >= n:
                raise ValueError("a resize's source row lies in another "
                                 "slab")
            x = x.index_select(axis, idx.to(x.device))
            continue
        pos = torch.arange(size, dtype=torch.float32, device=x.device)
        idx = torch.floor(pos * n / size).long().clamp_(0, n - 1)
        x = x.index_select(axis, idx)
    return x
