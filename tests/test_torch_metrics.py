"""The port's metrics (``cbim_tpu_torch.ops.metrics``) vs ``cbim_tpu``'s, on
the CPU.

The surfel tables must be equal exactly (the port keeps its own copy of the
module).  Dice runs on torch tensors in the port and on jax arrays in the
JAX package: counts summed in fp32 on both sides, equal to 1e-6.  The
surface distances run the same numpy/scipy arithmetic on both sides: equal
to 1e-12 relative, ``inf`` where a mask is empty.  Inputs are seeded numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.ops import _surfel_tables as jax_tables
from cbim_tpu.ops import metrics as jax_metrics
from cbim_tpu_torch.ops import _surfel_tables as tables
from cbim_tpu_torch.ops import metrics
from test_torch_threads import few_torch_threads  # noqa: F401

#: the host metrics: the same numpy/scipy arithmetic on both sides
HOST_RTOL = 1e-12
#: Dice from fp32 counts on both sides
DICE_RTOL = 1e-6


def test_surfel_normals_equal_jax():
    mine, ref = tables.neighbour_code_to_normals(), \
        jax_tables.neighbour_code_to_normals()
    assert len(mine) == len(ref) == 256
    for code, (a, b) in enumerate(zip(mine, ref)):
        np.testing.assert_array_equal(a, b, err_msg=str(code))


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (2.5, 0.7, 1.3),
                                     (5.0, 1.5625, 1.5625)])
def test_surfel_tables_equal_jax(spacing):
    np.testing.assert_array_equal(
        tables.create_table_neighbour_code_to_surface_area(spacing),
        jax_tables.create_table_neighbour_code_to_surface_area(spacing))
    np.testing.assert_array_equal(
        tables.create_table_neighbour_code_to_contour_length(spacing[1:]),
        jax_tables.create_table_neighbour_code_to_contour_length(spacing[1:]))
    np.testing.assert_array_equal(tables.encode_kernel_3d(),
                                  jax_tables.encode_kernel_3d())
    np.testing.assert_array_equal(tables.encode_kernel_2d(),
                                  jax_tables.encode_kernel_2d())


# ------------------------------------------------------------------- Dice

@pytest.mark.parametrize("shape,C", [((4000,), 5), ((17, 13, 11), 4),
                                     ((6, 40, 40), 16)])
def test_dice_per_class_matches_jax(shape, C):
    rng = np.random.default_rng(sum(shape))
    pred = rng.integers(0, C, size=shape)
    target = rng.integers(0, C, size=shape)
    target[..., 0] = C - 1          # every class present, one absent below
    pred[pred == 1] = 0
    got = metrics.dice_per_class(torch.from_numpy(pred),
                                 torch.from_numpy(target), C)
    ref = jax_metrics.dice_per_class(jnp.asarray(pred), jnp.asarray(target),
                                     C)
    for g, r in zip(got, ref):
        assert g.shape == (C,) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=DICE_RTOL)


@pytest.mark.parametrize("shape,block", [((17, 13, 11), 1000),   # ragged
                                         ((8, 16, 16), 512),     # exact
                                         ((70000,), 4096)])
def test_dice_per_class_split_matches_jax(shape, block):
    C = 4
    rng = np.random.default_rng(block)
    pred = rng.integers(0, C, size=shape).astype(np.int8)
    target = rng.integers(0, C, size=shape).astype(np.int8)
    got = metrics.dice_per_class_split(torch.from_numpy(pred),
                                       torch.from_numpy(target), C,
                                       block_size=block)
    ref = jax_metrics.dice_per_class_split(jnp.asarray(pred),
                                           jnp.asarray(target), C,
                                           block_size=block)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=DICE_RTOL)
    # and the unsplit counts
    full = metrics.dice_per_class(torch.from_numpy(pred),
                                  torch.from_numpy(target), C)
    np.testing.assert_allclose(got[0].numpy(), full[0].numpy(),
                               rtol=DICE_RTOL)


# ------------------------------------------------------ surface distances

def _blob(shape, center, radii):
    coords = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    return sum(((g - c) / r) ** 2
               for g, c, r in zip(coords, center, radii)) < 1


def _mask_pairs():
    """(name, gt, pred, spacing): 3D ellipsoids at anisotropic spacing,
    2D masks, both masks empty, one mask empty each way, noisy masks."""
    rng = np.random.default_rng(7)
    gt3 = _blob((20, 24, 22), (10, 12, 11), (6, 8, 5))
    pred3 = _blob((20, 24, 22), (11, 11, 12), (5, 9, 6))
    noisy3 = gt3 ^ (rng.random(gt3.shape) < 0.03)
    gt2 = _blob((40, 36), (20, 17), (12, 9))
    pred2 = _blob((40, 36), (18, 19), (10, 11)) | _blob((40, 36), (5, 5),
                                                        (3, 2))
    empty3 = np.zeros_like(gt3)
    return [
        ("3d_aniso", gt3, pred3, (2.5, 0.8, 1.2)),
        ("3d_noisy", gt3, noisy3, (1.0, 1.0, 1.0)),
        ("3d_corner", _blob((9, 9, 9), (0, 0, 0), (4, 3, 5)),
         _blob((9, 9, 9), (8, 8, 8), (3, 3, 3)), (1.5, 1.5, 1.5)),
        ("2d", gt2, pred2, (1.25, 0.9)),
        ("both_empty", empty3, empty3, (1.0, 1.0, 1.0)),
        ("pred_empty", gt3, empty3, (2.0, 1.0, 1.0)),
        ("gt_empty", empty3, pred3, (1.0, 1.0, 3.0)),
    ]


PAIRS = _mask_pairs()


@pytest.mark.parametrize("case", PAIRS, ids=[p[0] for p in PAIRS])
def test_surface_distances_asd_hd95_equal_jax(case):
    name, gt, pred, spacing = case
    got = metrics.surface_distances(gt, pred, spacing)
    ref = jax_metrics.surface_distances(gt, pred, spacing)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=HOST_RTOL)
    asd = metrics.average_surface_distance(*got)
    asd_ref = jax_metrics.average_surface_distance(*ref)
    hd = [metrics.robust_hausdorff(got[0], got[1], p, got[2], got[3])
          for p in (95.0, 100.0)]
    hd_ref = [jax_metrics.robust_hausdorff(ref[0], ref[1], p, ref[2], ref[3])
              for p in (95.0, 100.0)]
    np.testing.assert_allclose(asd, asd_ref, rtol=HOST_RTOL)
    np.testing.assert_allclose(hd, hd_ref, rtol=HOST_RTOL)
    # unweighted (areas None), as the reference's plain call
    np.testing.assert_allclose(
        metrics.average_surface_distance(got[0], got[1]),
        jax_metrics.average_surface_distance(ref[0], ref[1]), rtol=HOST_RTOL)
    if name == "both_empty":
        assert all(g.size == 0 for g in got)
    if name in ("both_empty", "pred_empty", "gt_empty"):
        assert np.isinf(hd[0]) and np.isinf(max(asd))
    else:
        assert np.isfinite(hd + list(asd)).all() and hd[0] > 0


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (3.0, 0.75, 0.75)])
def test_calculate_distance_equals_jax(spacing):
    """Per-class ASD/HD95 of a 4-class label map whose class 3 is absent
    from the prediction (inf) and class 2 misplaced."""
    shape = (18, 30, 26)
    true = np.zeros(shape, np.int8)
    true[_blob(shape, (9, 15, 13), (6, 10, 8))] = 1
    true[_blob(shape, (5, 8, 7), (3, 4, 4))] = 2
    true[_blob(shape, (12, 22, 18), (3, 4, 5))] = 3
    pred = np.zeros(shape, np.int8)
    pred[_blob(shape, (10, 14, 13), (6, 9, 9))] = 1
    pred[_blob(shape, (6, 10, 9), (3, 4, 3))] = 2
    got = metrics.calculate_distance(pred, true, spacing, 4)
    ref = jax_metrics.calculate_distance(pred, true, spacing, 4)
    for g, r in zip(got, ref):
        assert g.shape == (3,)
        np.testing.assert_allclose(g, r, rtol=HOST_RTOL)
    assert np.isinf(got[0][2]) and np.isinf(got[1][2])
    assert np.isfinite(got[0][:2]).all() and np.isfinite(got[1][:2]).all()
