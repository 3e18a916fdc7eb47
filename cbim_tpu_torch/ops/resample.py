"""Batched affine resampling (counterpart of ``affine_sample_3d_batch`` and
``affine_sample_2d`` of ``cbim_tpu/ops/resample.py``) with
``F.affine_grid`` / ``F.grid_sample`` semantics: align_corners=True, zeros
outside the image, (tri/bi)linear for the image and nearest (round half to
even) for the labels.

``theta`` (B, 3, 4) maps output normalized coordinates (x, y, z) = (W, H, D
axes) to input ones, as ``F.affine_grid`` reads it; in 2D (B, 2, 3), rows
(x, y) = (W, H axes).  The centre crop is
fused: the grid is built only over the ``out_shape`` sub-box of the full
output grid (offset ``out_offset``), exactly what resampling the whole
volume and slicing would give, at a fraction of the work.

Size-1 axes follow ``F.affine_grid``: a unit-size axis maps to normalized
coordinate 0 (torch >= 1.3), the same as the JAX package
(``_normalized_coords``).  No Pallas kernel stands behind this module; it
is plain PyTorch (``grid_sample``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def axis_coords(size: int, device=None) -> torch.Tensor:
    """Normalized coordinates of the voxels of one axis as ``F.affine_grid``
    places them with align_corners=True: linspace(-1, 1), and 0 for a
    unit-size axis."""
    if size == 1:
        return torch.zeros(1, device=device)
    return torch.linspace(-1.0, 1.0, size, device=device)


def affine_grid_box(theta: torch.Tensor, full_shape, out_shape,
                    out_offset) -> torch.Tensor:
    """``F.affine_grid(theta, (B, C, *full_shape), align_corners=True)``
    restricted to the sub-box ``out_offset + out_shape``: (B, *out_shape,
    nd) in (x, y[, z]) order, for nd = 2 or 3 spatial axes."""
    nd = len(full_shape)
    t = theta.float().reshape(theta.shape[0], nd, nd + 1, *[1] * nd)
    grid = None
    for k in range(nd):      # coordinate k (x, y, z) runs along axis nd-1-k
        ax = nd - 1 - k
        lo, n = out_offset[ax], out_shape[ax]
        shape = [1] * nd
        shape[ax] = n
        c = axis_coords(full_shape[ax], theta.device)[lo:lo + n].view(shape)
        term = t[:, :, k] * c
        grid = term if grid is None else grid + term
    return (grid + t[:, :, nd]).movedim(1, -1)


def affine_sample_3d_batch(img: torch.Tensor, lab: torch.Tensor,
                           theta: torch.Tensor, out_shape=None):
    """img (B, D, H, W, C) float, lab (B, D, H, W) int, theta (B, 3, 4) ->
    (img_out (B, *out_shape, C) in img's dtype, lab_out (B, *out_shape) in
    lab's dtype), the centred ``out_shape`` box of the output grid; the
    layout of the JAX package's function."""
    return _affine_sample_batch(img, lab, theta, out_shape)


def affine_sample_2d_batch(img: torch.Tensor, lab: torch.Tensor,
                           theta: torch.Tensor, out_shape=None):
    """img (B, H, W, C) float, lab (B, H, W) int, theta (B, 2, 3) ->
    bilinear image and nearest labels in the centred ``out_shape`` box: the
    batched form of the JAX package's ``affine_sample_2d``, crop fused."""
    return _affine_sample_batch(img, lab, theta, out_shape)


def _affine_sample_batch(img, lab, theta, out_shape):
    full = tuple(img.shape[1:-1])
    out_shape = full if out_shape is None else tuple(int(s) for s in out_shape)
    out_offset = tuple((f - o) // 2 for f, o in zip(full, out_shape))
    grid = affine_grid_box(theta, full, out_shape, out_offset)
    src = img.float().movedim(-1, 1)                        # (B, C, *full)
    img_out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
    lab_out = F.grid_sample(lab[:, None].float(), grid, mode="nearest",
                            padding_mode="zeros", align_corners=True)
    return (img_out.movedim(1, -1).to(img.dtype).contiguous(),
            lab_out[:, 0].to(lab.dtype))
