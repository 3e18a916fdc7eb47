"""Host-side resampling of volumes for prediction (the port's own copy of
``resample_to_spacing`` and ``resample_label_to_shape`` of
``cbim_tpu/data/conversion/utils.py``).

scipy cubic-spline zoom (order 3, prefiltered) for images, the
interpolation family of the reference's sitkBSpline, and nearest
(order 0) for labels, on (z, y, x) numpy arrays.
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
