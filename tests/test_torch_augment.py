"""The port's augmentation and affine resample vs ``cbim_tpu``'s, on the CPU.

The JAX package draws from ``jax.random`` and the port from
``torch.Generator``s, so random ops are held against the JAX package by
feeding both the same numbers (numpy, seeded, or the JAX draws
themselves); their draws are checked for range only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cbim_tpu.ops import augment as jax_aug
from cbim_tpu.ops.resample import _normalized_coords
from cbim_tpu.ops.resample import affine_sample_3d_batch as jax_affine_batch
from cbim_tpu_torch.data.pipeline import AugRecipe, build_batch_aug
from cbim_tpu_torch.ops import augment
from cbim_tpu_torch.ops.resample import affine_sample_3d_batch, axis_coords
from test_torch_threads import few_torch_threads  # noqa: F401


def _thetas(n, seed):
    """Random affines, rows (x, y, z), near the identity as training draws."""
    rng = np.random.default_rng(seed)
    th = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    th += rng.uniform(-0.3, 0.3, size=(n, 3, 4)).astype(np.float32)
    return th


def _volumes(B, shape, C, classes, seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, *shape, C)).astype(np.float32)
    lab = rng.integers(0, classes, size=(B, *shape)).astype(np.int8)
    return img, lab


@pytest.mark.parametrize("shape,out", [((12, 14, 16), (8, 8, 10)),
                                       ((9, 10, 11), (9, 10, 11))])
def test_affine_sample_matches_jax_for_fixed_thetas(shape, out):
    """Trilinear image and nearest labels, centre crop fused, zeros outside:
    the image to 1e-5 and the labels exactly."""
    img, lab = _volumes(3, shape, 2, 5, seed=sum(shape))
    th = _thetas(3, seed=len(out))
    th[0] = np.eye(3, 4)                 # identity: a plain centre crop
    j_img, j_lab = jax_affine_batch(jnp.asarray(img), jnp.asarray(lab),
                                    jnp.asarray(th), out_shape=out)
    t_img, t_lab = affine_sample_3d_batch(
        torch.from_numpy(img), torch.from_numpy(lab), torch.from_numpy(th),
        out_shape=out)
    assert t_img.shape == (3, *out, 2) and t_lab.shape == (3, *out)
    assert t_lab.dtype == torch.int8
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))
    off = [(s - o) // 2 for s, o in zip(shape, out)]
    crop = img[0, off[0]:off[0] + out[0], off[1]:off[1] + out[1],
               off[2]:off[2] + out[2]]
    np.testing.assert_allclose(t_img[0].numpy(), crop, atol=1e-5)


def test_affine_grid_box_is_a_slice_of_affine_grid():
    th = torch.from_numpy(_thetas(2, seed=7))
    full = (7, 9, 11)
    ref = F.affine_grid(th, (2, 1, *full), align_corners=True)
    from cbim_tpu_torch.ops.resample import affine_grid_box
    box = affine_grid_box(th, full, (3, 5, 4), (2, 1, 6))
    torch.testing.assert_close(box, ref[:, 2:5, 1:6, 6:10], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.filterwarnings("ignore:Since version 1.3.0")
def test_size_one_axis_maps_to_zero_like_affine_grid():
    """ROADMAP C2, decided: the port takes ``F.affine_grid``'s semantics.
    Since torch 1.3 ``affine_grid(align_corners=True)`` puts a unit-size
    axis at normalized 0, not -1, which is also what
    ``cbim_tpu/ops/resample.py:31-32`` does; the two agree."""
    ref = F.affine_grid(torch.eye(3, 4)[None], (1, 1, 1, 3, 4),
                        align_corners=True)
    assert float(ref[0, 0, 0, 0, 2]) == 0.0           # the D axis, size 1
    assert axis_coords(1).tolist() == [0.0]
    assert np.asarray(_normalized_coords(1)).tolist() == [0.0]
    np.testing.assert_allclose(axis_coords(4).numpy(),
                               np.asarray(_normalized_coords(4)), atol=1e-7)
    img, lab = _volumes(1, (1, 6, 7), 1, 3, seed=1)
    th = _thetas(1, seed=2)
    j_img, j_lab = jax_affine_batch(jnp.asarray(img), jnp.asarray(lab),
                                    jnp.asarray(th))
    t_img, t_lab = affine_sample_3d_batch(
        torch.from_numpy(img), torch.from_numpy(lab), torch.from_numpy(th))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-5)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))


def _jax_theta_draws(key, scale, rotate, translate, shear):
    """The numbers ``cbim_tpu.ops.augment.random_theta_3d`` draws from
    ``key``, by the same calls."""
    ks = jax.random.split(key, 13)

    def u(k, lo, hi):
        return float(jax.random.uniform(k, (), jnp.float32, lo, hi))

    scales = [u(ks[i], 1 - s, 1.0 / (1 - s)) if s > 0 else 1.0
              for i, s in enumerate(scale)]
    shears = [u(ks[3 + i], -shear[i // 2], shear[i // 2]) for i in range(6)]
    trans = [u(ks[9 + i], -t, t) if t > 0 else 0.0
             for i, t in enumerate(translate)]
    kx, ky, kz = jax.random.split(ks[12], 3)
    degs = [int(jax.random.randint(k, (), -int(r), max(int(r), 1)))
            for k, r in zip((kx, ky, kz), rotate)]
    return scales, shears, trans, degs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_theta_from_jax_draws_matches_random_theta_3d(seed):
    scale, rotate, translate, shear = (0.3, 0.2, 0.1), (30, 20, 10), \
        (0.05, 0.0, 0.1), (0.05, 0.05, 0.05)
    key = jax.random.PRNGKey(seed)
    ref = jax_aug.random_theta_3d(key, scale, rotate, translate, shear)
    draws = _jax_theta_draws(key, scale, rotate, translate, shear)
    th = augment.theta_3d_from_draws(*([d] for d in draws))
    # fp32 products of cos/sin and scales: a few ulp of O(1) entries
    np.testing.assert_allclose(th[0].numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_random_theta_draws_stay_in_their_ranges():
    gen = torch.Generator().manual_seed(0)
    th = augment.random_theta_3d(gen, 4000, scale=0.3, rotate=0,
                                 translate=0.0, shear=0.0)
    diag = th[:, [0, 1, 2], [0, 1, 2]]
    assert float(diag.min()) >= 0.7 and float(diag.max()) <= 1 / 0.7
    assert float(diag.max()) > 1.3                 # the range is covered
    assert float(th[:, :, 3].abs().max()) == 0.0    # translate 0
    rot = augment.random_theta_3d(gen, 2000, scale=0.0, rotate=30,
                                  translate=0.0, shear=0.0)
    eye = torch.eye(3).expand(2000, 3, 3)       # pure rotations
    torch.testing.assert_close(rot[:, :, :3] @ rot[:, :, :3].transpose(1, 2),
                               eye, atol=1e-5, rtol=0)
    # about x only: integer degrees in [-30, 30), both ends reached
    rx = augment.random_theta_3d(gen, 2000, scale=0.0, rotate=(30, 0, 0),
                                 translate=0.0, shear=0.0)
    deg = torch.rad2deg(torch.atan2(rx[:, 2, 1], rx[:, 1, 1])).double()
    torch.testing.assert_close(deg, deg.round(), atol=1e-3, rtol=0)
    assert int(deg.round().min()) == -30 and int(deg.round().max()) == 29


def test_intensity_ops():
    gen = torch.Generator().manual_seed(1)
    img = torch.zeros(2, 16, 16, 16, 1)
    noisy = augment.gaussian_noise(img, gen, std=0.5)
    assert abs(float(noisy.std()) - 0.5) < 0.02
    f = augment.draw_uniform(gen, 2, 0.7, 1.3)
    out = augment.brightness_multiply(img + 2.0, f)
    torch.testing.assert_close(out[:, 0, 0, 0, 0], 2.0 * f)


def test_batch_aug_without_randomness_is_the_centre_crop():
    recipe = AugRecipe(affine_prob=1.0, affine_pad=(4, 4, 4), scale=0.0,
                       rotate=0, translate=0.0, shear=0.0)
    fn = build_batch_aug(recipe, (8, 8, 8))
    img, lab = _volumes(2, (12, 12, 12), 1, 4, seed=3)
    out_img, out_lab = fn(torch.from_numpy(img), torch.from_numpy(lab).long(),
                          torch.Generator(), torch.Generator())
    np.testing.assert_allclose(out_img.numpy(), img[:, 2:10, 2:10, 2:10],
                               atol=1e-5)
    np.testing.assert_array_equal(out_lab.numpy(), lab[:, 2:10, 2:10, 2:10])


def test_batch_aug_synthetic_recipe_shapes_and_labels():
    recipe = AugRecipe(
        affine_prob=0.5, affine_pad=(6, 6, 6), scale=(0.3,) * 3,
        rotate=(30,) * 3, pre_ops=(("gaussian_noise", 1.0, {"std": 0.02}),),
        post_ops=(("brightness_multiply", 0.2, {"range": (0.7, 1.3)}),))
    fn = build_batch_aug(recipe, (10, 10, 10))
    img, lab = _volumes(4, (16, 16, 16), 1, 3, seed=4)
    out_img, out_lab = fn(torch.from_numpy(img), torch.from_numpy(lab).long(),
                          torch.Generator().manual_seed(0),
                          torch.Generator().manual_seed(0))
    assert out_img.shape == (4, 10, 10, 10, 1)
    assert out_lab.shape == (4, 10, 10, 10) and out_lab.dtype == torch.int64
    assert set(out_lab.unique().tolist()) <= {0, 1, 2}
    assert torch.isfinite(out_img).all()


def test_unknown_op_raises():
    """An op name the JAX package does not know raises ``ValueError`` when
    the batch reaches it, as its ``_apply_op`` does; every name it knows
    (and ``full_volume``) builds."""
    img, lab = _volumes(2, (10, 10, 10), 1, 3, seed=5)
    fn = build_batch_aug(AugRecipe(post_ops=(("sharpen", 1.0, {}),)),
                         (8, 8, 8))
    with pytest.raises(ValueError, match="unknown aug op 'sharpen'"):
        fn(torch.from_numpy(img), torch.from_numpy(lab).long(),
           torch.Generator(), torch.Generator())
    build_batch_aug(AugRecipe(full_volume=True, pre_ops=(
        ("gamma", 1.0, {"range": (0.7, 1.5)}),), post_ops=(
        ("gaussian_noise", 0.2, {"std_range": (0.0, 0.2)}),)), (8, 8, 8))
