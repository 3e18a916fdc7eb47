"""Evaluation metrics (counterpart of ``cbim_tpu/ops/metrics.py``): Dice on
the tensors' device, surface distances (ASD/HD95) on the host.

- ``dice_per_class`` / ``dice_per_class_split`` mirror the reference's
  metric/utils.py:62-82 (``calculate_dice``) and :33-52
  (``calculate_dice_split``): one-hot counts over the flattened voxels,
  2*intersection / (sum + 1e-5) per class.  The ``_split`` variant bounds
  the one-hot's memory on large volumes.

- ``calculate_distance`` mirrors metric/utils.py:8-29: per-class average
  symmetric surface distance and robust (percentile) Hausdorff, with the
  surfel-AREA-WEIGHTED semantics of the DeepMind surface-distance metric the
  reference vendors (metric/metrics.py:265-717): surface elements live on
  voxel corners (2x2x2 neighbour codes) and are weighted by their
  marching-cubes triangle area (``_surfel_tables``).  The distance
  transform runs on the host with ``scipy.ndimage``, the same numpy/scipy
  arithmetic as the JAX package.  Empty masks yield ``inf`` (callers clip,
  see ``training.validation``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from ._surfel_tables import (create_table_neighbour_code_to_contour_length,
                             create_table_neighbour_code_to_surface_area,
                             encode_kernel_2d, encode_kernel_3d)


# ---------------------------------------------------------------------------
# Dice (device)
# ---------------------------------------------------------------------------

def _one_hot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(x.reshape(-1).long(), num_classes).float()


def dice_per_class(pred: torch.Tensor, target: torch.Tensor,
                   num_classes: int):
    """Returns (dice, intersection, summ), each (C,), on the inputs' device.
    Matches calculate_dice."""
    pred_mask = _one_hot(pred, num_classes)
    target_mask = _one_hot(target, num_classes)
    intersection = (pred_mask * target_mask).sum(0)
    summ = (pred_mask + target_mask).sum(0) + 1e-5
    return 2.0 * intersection / summ, intersection, summ


def dice_per_class_split(pred: torch.Tensor, target: torch.Tensor,
                         num_classes: int, block_size: int = 64 * 64 * 64):
    """Chunked variant (calculate_dice_split): the same totals, one
    block's one-hot at a time.  Unlike ``dice_per_class``, ``summ`` is
    returned without the 1e-5, as the JAX package returns it."""
    pred = pred.reshape(-1)
    target = target.reshape(-1)
    inter = torch.zeros(num_classes, dtype=torch.float32, device=pred.device)
    summ = torch.zeros_like(inter)
    for lo in range(0, pred.numel(), block_size):
        pm = _one_hot(pred[lo:lo + block_size], num_classes)
        tm = _one_hot(target[lo:lo + block_size], num_classes)
        inter += (pm * tm).sum(0)
        summ += (pm + tm).sum(0)
    return 2.0 * inter / (summ + 1e-5), inter, summ


# ---------------------------------------------------------------------------
# Surface distances (host): surfel-area-weighted, DeepMind semantics
# ---------------------------------------------------------------------------

def _bounding_box(mask: np.ndarray):
    """Exact per-axis min/max of the set voxels, or (None, None) if empty."""
    if not mask.any():
        return None, None
    coords = [np.any(mask, axis=tuple(j for j in range(mask.ndim) if j != i))
              for i in range(mask.ndim)]
    mins = np.array([int(np.argmax(c)) for c in coords])
    maxs = np.array([int(len(c) - 1 - np.argmax(c[::-1])) for c in coords])
    return mins, maxs


def surface_distances(mask_gt: np.ndarray, mask_pred: np.ndarray, spacing):
    """Area-weighted surface-element distances (metric/metrics.py:265-553).

    Returns (dist_gt_to_pred, dist_pred_to_gt, areas_gt, areas_pred), each a
    1-D array sorted by (distance, area) within each direction.  Distances
    are EDTs (sampling=spacing) to the OTHER mask's border corners; areas are
    the marching-cubes surfel areas from the 2x2x2 neighbour code (contour
    lengths from the 2x2 code for 2D masks, metric/metrics.py:380-399).
    """
    mask_gt = np.asarray(mask_gt, dtype=bool)
    mask_pred = np.asarray(mask_pred, dtype=bool)
    spacing = np.asarray(spacing, dtype=np.float64)
    empty = np.array([], dtype=np.float64)

    bbox_min, bbox_max = _bounding_box(mask_gt | mask_pred)
    if bbox_min is None:
        return empty, empty, empty, empty

    # crop to the union bounding box, +1 voxel of zeros at the high side so
    # the 2x2(x2) correlate sees the full border (metric/metrics.py:187-201)
    def crop(mask):
        out = np.zeros(tuple(bbox_max - bbox_min + 2), np.uint8)
        src = tuple(slice(lo, hi + 1) for lo, hi in zip(bbox_min, bbox_max))
        out[tuple(slice(0, hi - lo + 1) for lo, hi in
                  zip(bbox_min, bbox_max))] = mask[src]
        return out

    if mask_gt.ndim == 2:
        kernel = encode_kernel_2d()
        area_table = create_table_neighbour_code_to_contour_length(spacing)
        full = 0b1111
    else:
        kernel = encode_kernel_3d()
        area_table = create_table_neighbour_code_to_surface_area(spacing)
        full = 0b11111111
    codes_gt = ndimage.correlate(crop(mask_gt), kernel, mode="constant",
                                 cval=0)
    codes_pred = ndimage.correlate(crop(mask_pred), kernel, mode="constant",
                                   cval=0)
    borders_gt = (codes_gt != 0) & (codes_gt != full)
    borders_pred = (codes_pred != 0) & (codes_pred != full)

    def distmap(borders):
        if borders.any():
            return ndimage.distance_transform_edt(~borders, sampling=spacing)
        return np.full(borders.shape, np.inf)

    d_gt_to_pred = distmap(borders_pred)[borders_gt]
    d_pred_to_gt = distmap(borders_gt)[borders_pred]
    a_gt = area_table[codes_gt[borders_gt]]
    a_pred = area_table[codes_pred[borders_pred]]

    def sort_pair(d, a):
        if d.size == 0:
            return d, a
        order = np.lexsort((a, d))
        return d[order], a[order]

    d_gt_to_pred, a_gt = sort_pair(d_gt_to_pred, a_gt)
    d_pred_to_gt, a_pred = sort_pair(d_pred_to_gt, a_pred)
    return d_gt_to_pred, d_pred_to_gt, a_gt, a_pred


def average_surface_distance(dist_gt_to_pred, dist_pred_to_gt,
                             areas_gt=None, areas_pred=None):
    """Area-weighted mean distance each way (metric/metrics.py:579-635)."""
    if areas_gt is None:
        areas_gt = np.ones_like(dist_gt_to_pred)
    if areas_pred is None:
        areas_pred = np.ones_like(dist_pred_to_gt)
    with np.errstate(invalid="ignore"):
        d1 = (float(np.sum(dist_gt_to_pred * areas_gt) / np.sum(areas_gt))
              if dist_gt_to_pred.size else np.inf)
        d2 = (float(np.sum(dist_pred_to_gt * areas_pred) / np.sum(areas_pred))
              if dist_pred_to_gt.size else np.inf)
    return d1, d2


def robust_hausdorff(dist_gt_to_pred, dist_pred_to_gt, percent: float = 95.0,
                     areas_gt=None, areas_pred=None):
    """Area-weighted percentile Hausdorff (metric/metrics.py:641-717):
    the distance at which the cumulative area fraction reaches percent/100,
    max over both directions."""
    if areas_gt is None:
        areas_gt = np.ones_like(dist_gt_to_pred)
    if areas_pred is None:
        areas_pred = np.ones_like(dist_pred_to_gt)

    def one_way(d, a):
        if d.size == 0:
            return np.inf
        cum = np.cumsum(a) / np.sum(a)
        idx = np.searchsorted(cum, percent / 100.0)
        return d[min(idx, len(d) - 1)]

    return float(max(one_way(dist_gt_to_pred, areas_gt),
                     one_way(dist_pred_to_gt, areas_pred)))


def calculate_distance(label_pred, label_true, spacing, num_classes: int,
                       percentage: float = 95.0):
    """Per-class ASD and HD95 (reference metric/utils.py:8-29).

    ``label_pred`` / ``label_true`` are integer numpy volumes; ``spacing``
    is the (z, y, x) voxel spacing.  Returns two numpy arrays of length C-1
    (background excluded).  NaN/inf handling (clip to 500) is done by the
    caller, matching reference training/validation.py:59-60.
    """
    label_pred = np.asarray(label_pred)
    label_true = np.asarray(label_true)
    spacing = np.asarray(spacing, dtype=np.float64)

    asd = np.zeros(num_classes - 1)
    hd = np.zeros(num_classes - 1)
    for i in range(num_classes - 1):
        d_gt, d_pred, a_gt, a_pred = surface_distances(
            label_true == (i + 1), label_pred == (i + 1), spacing)
        a1, a2 = average_surface_distance(d_gt, d_pred, a_gt, a_pred)
        asd[i] = (a1 + a2) / 2.0
        hd[i] = robust_hausdorff(d_gt, d_pred, percentage, a_gt, a_pred)
    return asd, hd
