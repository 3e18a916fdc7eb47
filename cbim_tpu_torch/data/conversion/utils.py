"""Offline conversion ops of the port (counterpart of
``cbim_tpu/data/conversion/utils.py``; reference dataset_conversion/utils.py).

The reference uses SimpleITK (``ResampleXYZAxis``, ``ResampleLabelToRef``,
``ITKReDirection``, ``CropForeground``); here they are scipy and numpy on
(z, y, x) arrays with spacings: scipy cubic-spline zoom (order 3,
prefiltered) for images, the interpolation family of the reference's
sitkBSpline, and nearest (order 0) for labels.  The prediction CLI resamples
its requests with the same helpers.  Host code, offline.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def resample_to_spacing(img: np.ndarray, spacing, target_spacing,
                        order: int = 3) -> np.ndarray:
    """Resample a (z, y, x) volume from ``spacing`` to ``target_spacing``;
    each axis gets round(size * spacing / target) voxels."""
    spacing = np.asarray(spacing, np.float64)
    target = np.asarray(target_spacing, np.float64)
    out_shape = tuple(int(round(s * sp / tp))
                      for s, sp, tp in zip(img.shape, spacing, target))
    return resample_to_shape(img, out_shape, order=order)


def resample_to_shape(img: np.ndarray, out_shape, order: int = 3) -> np.ndarray:
    """Resample a volume to an exact output shape."""
    if tuple(img.shape) == tuple(out_shape):
        return np.ascontiguousarray(img)
    zoom = [o / s for o, s in zip(out_shape, img.shape)]
    dtype = img.dtype
    out = ndimage.zoom(img.astype(np.float32), zoom, order=order,
                       mode="nearest", grid_mode=False)
    # zoom can be off by one voxel on an axis; pad/crop to the exact shape
    slices = tuple(slice(0, min(a, b)) for a, b in zip(out.shape, out_shape))
    result = np.zeros(out_shape, np.float32)
    result[slices] = out[slices]
    if order == 0:
        return result.astype(dtype)
    return result


def resample_label_to_shape(lab: np.ndarray, out_shape) -> np.ndarray:
    """Nearest-neighbour label resample (ResampleLabelToRef equivalent)."""
    return resample_to_shape(lab, out_shape, order=0)


def reorient_to_ras(data: np.ndarray, affine: np.ndarray):
    """Flip and permute axes so that the affine's rotation is axis-aligned
    with a positive diagonal: the equivalent of the reference's
    ``ITKReDirection`` (dataset_conversion/utils.py:37-64), which
    normalises the image direction.  data (z, y, x); returns (data,
    new_affine), unchanged when two world axes share a dominant voxel
    axis."""
    rot = affine[:3, :3]
    perm = np.argmax(np.abs(rot), axis=1)         # dominant axis per world dim
    if len(set(perm.tolist())) != 3:
        return data, affine
    # data is (z, y, x), the reverse of the world order: work in (x, y, z)
    data_xyz = np.transpose(np.transpose(data, (2, 1, 0)), perm)
    new_rot = rot[:, perm]
    flips = tuple(i for i in range(3) if new_rot[i, i] < 0)
    if flips:
        data_xyz = np.flip(data_xyz, axis=flips)
    new_affine = affine.copy()
    new_affine[:3, :3] = np.abs(np.diag(np.diag(new_rot)))
    return np.ascontiguousarray(np.transpose(data_xyz, (2, 1, 0))), new_affine


def CropForeground(img: np.ndarray, lab: np.ndarray, context_size=(10, 30, 30)):
    """Crop image and label to the label's bounding box grown by
    ``context_size`` (z, y, x) voxels, clamped to the volume
    (dataset_conversion/utils.py:67-108); unchanged without foreground."""
    assert img.shape == lab.shape
    fg = lab > 0
    if not fg.any():
        return img, lab
    idx = np.where(fg)
    box = tuple(slice(max(0, int(i.min()) - c),
                      min(s, int(i.max()) + 1 + c))
                for i, c, s in zip(idx, context_size, img.shape))
    return np.ascontiguousarray(img[box]), np.ascontiguousarray(lab[box])
