"""Batched affine resampling (counterpart of ``affine_sample_3d_batch``,
``affine_sample_2d`` and ``affine_sample_3d_fullvol_batch`` of
``cbim_tpu/ops/resample.py``, and of its voxel-coordinate gathers) with
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
(``_normalized_coords``).

The full-volume resample (``affine_sample_3d_fullvol_batch``, ACDC-style
recipes on the device cache) and the elastic ops sample at fractional
coordinates in voxel units instead, by explicit corner gathers
(``linear_gather``, ``nearest_gather``): the arithmetic of the JAX
package's ``_trilinear_gather`` and ``_nearest_gather`` (corner weights,
validity masks, round half to even), so no trip through normalised
coordinates can move a label's nearest voxel at an exact .5 tie.  No
Pallas kernel stands behind this module; it is plain PyTorch.  (The JAX
package's TPU-tiled gather, ``_tiled_gather_3d``, is a TPU lowering of the
same arithmetic and has no counterpart.)
"""

from __future__ import annotations

import itertools

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


def _flat_index(idx, shape):
    """Row-major linear index of per-axis integer coordinates, each clamped
    into its axis."""
    lin = None
    for i, s in zip(idx, shape):
        i = i.clamp(0, s - 1)
        lin = i if lin is None else lin * s + i
    return lin


def linear_gather(src: torch.Tensor, coords) -> torch.Tensor:
    """(Tri/bi)linear samples of src (B, *spatial, C) at per-sample
    fractional voxel coordinates ``coords`` (one (B, *out) tensor per
    spatial axis, broadcastable), zeros outside [0, size - 1]: (B, *out, C)
    in src's dtype, summed in fp32 corner by corner in the JAX package's
    order (``_trilinear_gather``, ``_bilinear_gather_2d``)."""
    B, C = src.shape[0], src.shape[-1]
    shape = tuple(src.shape[1:-1])
    coords = torch.broadcast_tensors(*coords)
    out_shape = coords[0].shape[1:]
    flat = src.reshape(B, -1, C)
    lo = [torch.floor(f).long() for f in coords]
    frac = [f - i.to(f.dtype) for f, i in zip(coords, lo)]
    out = torch.zeros((B, *out_shape, C), dtype=torch.float32,
                      device=src.device)
    for corner in itertools.product((0, 1), repeat=len(shape)):
        idx = [i + d for i, d in zip(lo, corner)]
        w = None
        valid = None
        for d, f, i, s in zip(corner, frac, idx, shape):
            t = f if d else 1.0 - f
            w = t if w is None else w * t
            ok = (i >= 0) & (i < s)
            valid = ok if valid is None else valid & ok
        lin = _flat_index(idx, shape).reshape(B, -1, 1).expand(-1, -1, C)
        vals = torch.gather(flat, 1, lin).view(B, *out_shape, C)
        out = out + (w * valid)[..., None].float() * vals.float()
    return out.to(src.dtype)


def nearest_gather(lab: torch.Tensor, coords) -> torch.Tensor:
    """Nearest samples of lab (B, *spatial) at fractional voxel coordinates
    (round half to even, as ``jnp.rint`` and grid_sample's nearest), 0
    outside: (B, *out) in lab's dtype."""
    B = lab.shape[0]
    shape = tuple(lab.shape[1:])
    coords = torch.broadcast_tensors(*coords)
    idx = [torch.round(f).long() for f in coords]
    valid = None
    for i, s in zip(idx, shape):
        ok = (i >= 0) & (i < s)
        valid = ok if valid is None else valid & ok
    lin = _flat_index(idx, shape).reshape(B, -1)
    vals = torch.gather(lab.reshape(B, -1), 1, lin).view(valid.shape)
    return torch.where(valid, vals, torch.zeros((), dtype=lab.dtype,
                                                device=lab.device))


def affine_coords_3d_fullvol(theta, extents, place, out_offsets, out_shape):
    """Sample coordinates (fz, fy, fx), each (B, *out_shape), of the
    full-volume affine: the grid normalised over each sample's true extent
    (B, 3) (the reference's ``F.affine_grid`` over the whole volume,
    augmentation.py:287-289), evaluated on the crop box at ``out_offsets``
    (B, 3, volume coordinates), returned in cache voxels, offset by the
    volume's placement ``place`` (3,) in the zero-padded cache row (the
    JAX package's ``_affine_coords_3d_fullvol``)."""
    device = theta.device
    extent = torch.as_tensor(extents, device=device).float()
    off = torch.as_tensor(out_offsets, device=device).float()
    place = torch.as_tensor(place, device=device).float()

    def axis(i, n):
        s = extent[:, i:i + 1]
        o = off[:, i:i + 1] + torch.arange(n, dtype=torch.float32,
                                           device=device)
        return torch.where(s > 1, -1.0 + 2.0 * o / (s - 1.0).clamp_min(1.0),
                           0.0)

    z = axis(0, out_shape[0])[:, :, None, None]
    y = axis(1, out_shape[1])[:, None, :, None]
    x = axis(2, out_shape[2])[:, None, None, :]
    t = theta.float()[:, :, :, None, None, None]
    sx = t[:, 0, 0] * x + t[:, 0, 1] * y + t[:, 0, 2] * z + t[:, 0, 3]
    sy = t[:, 1, 0] * x + t[:, 1, 1] * y + t[:, 1, 2] * z + t[:, 1, 3]
    sz = t[:, 2, 0] * x + t[:, 2, 1] * y + t[:, 2, 2] * z + t[:, 2, 3]
    e = extent[:, :, None, None, None]
    fz = (sz + 1.0) * (e[:, 0] - 1.0) / 2.0 + place[0]
    fy = (sy + 1.0) * (e[:, 1] - 1.0) / 2.0 + place[1]
    fx = (sx + 1.0) * (e[:, 2] - 1.0) / 2.0 + place[2]
    return fz, fy, fx


def affine_sample_3d_fullvol_batch(img, lab, theta, extents, out_offsets,
                                   place, out_shape):
    """Batched affine resample with full-volume grid semantics from a
    zero-padded cache: img (B, Dc, Hc, Wc, C) cache rows, lab (B, Dc, Hc,
    Wc), theta (B, 3, 4), extents (B, 3) true shapes, out_offsets (B, 3)
    crop starts in volume coordinates, place (3,) the cache margins ->
    (img (B, *out_shape, C) in img's dtype, lab (B, *out_shape)).

    The reference's affine of the whole volume and then random crop
    (dataset_acdc.py:141-149 + crop_3d), evaluated on the crop box only.
    Samples outside the volume read the cache's zero margin (the cache
    builder keeps one on every side a sample can reach) or fall outside the
    row: zeros either way, as ``grid_sample(padding_mode='zeros')``."""
    coords = affine_coords_3d_fullvol(theta, extents, place, out_offsets,
                                      tuple(int(s) for s in out_shape))
    return linear_gather(img, coords), nearest_gather(lab, coords)
