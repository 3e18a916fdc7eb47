"""Every augmentation op of the port against ``cbim_tpu.ops.augment``, on
the CPU.

The JAX ops draw their scalars from a key and run on one sample (the
pipeline vmaps them); the port's take the drawn scalars and a batch.  Each
test draws the numbers the JAX op draws from its keys, by the same calls,
feeds them to the port, and holds the port's batch against the vmapped JAX
op.  Batches of 3 samples with different ranges check that the statistics
are per sample.  Tolerances: 1e-6 of max|ref| (plus 1e-6 relative) for the
pointwise and statistic ops (fp32 reductions in another order), 1e-5 for
the blur and the elastic image (sums of taps or corners in another order);
labels exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.data.pipeline import _apply_op as jax_apply_op
from cbim_tpu.ops import augment as J
from cbim_tpu_torch.ops import augment as A
from test_torch_threads import few_torch_threads  # noqa: F401

KEYS = jax.random.split(jax.random.PRNGKey(7), 3)


def _batch(shape=(6, 7, 8), C=1, classes=4, seed=0):
    """3 samples of very different ranges: the statistics must be per
    sample (a batch-wide min or mean would move the small ones)."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(3, *shape, C)).astype(np.float32)
    img *= np.array([0.1, 5.0, 300.0], np.float32).reshape(3, *[1] * (len(shape) + 1))
    img += np.array([0.0, -20.0, 1000.0], np.float32).reshape(3, *[1] * (len(shape) + 1))
    lab = rng.integers(0, classes, size=(3, *shape)).astype(np.int32)
    return img, lab


def _uniform(lo, hi, keys=KEYS):
    return np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (), jnp.float32, lo, hi))(keys))


def _close(out, ref, rel=1e-6):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    scale = np.abs(ref).reshape(len(ref), -1).max(1)
    for b in range(len(ref)):        # each sample at its own scale
        np.testing.assert_allclose(out[b], ref[b], rtol=rel,
                                   atol=rel * scale[b], err_msg=f"sample {b}")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_brightness_additive_matches_jax():
    img, _ = _batch()
    shift = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (), jnp.float32) * 0.1 + 0.0)(KEYS))
    ref = jax.vmap(lambda x, k: J.brightness_additive(x, k, 0.1))(img, KEYS)
    _close(A.brightness_additive(_t(img), _t(shift)).numpy(), ref)


@pytest.mark.parametrize("retain", [True, False])
def test_gamma_matches_jax_per_sample(retain):
    img, _ = _batch()
    g = _uniform(0.7, 1.5)
    ref = jax.vmap(lambda x, k: J.gamma(x, k, (0.7, 1.5), retain))(img, KEYS)
    _close(A.gamma(_t(img), _t(g), retain).numpy(), ref)


def test_gamma_leaves_a_constant_sample_and_draws_no_nan():
    img, _ = _batch()
    img[1] = 3.25                                  # constant: range 0
    img[2] = np.abs(img[2] - 1000.0)               # zeros-adjacent base
    img[2].reshape(-1)[:5] = img[2].min()          # several base-0 voxels
    g = _uniform(0.5, 2.0)
    ref = np.asarray(jax.vmap(
        lambda x, k: J.gamma(x, k, (0.5, 2.0), True))(img, KEYS))
    out = A.gamma(_t(img), _t(g), True).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[1], img[1])
    _close(out, ref)


def test_masked_gamma_matches_jax():
    """The full-volume form: statistics over the mask (the true volume in a
    zero-padded cache row), zeros outside it."""
    rng = np.random.default_rng(3)
    cache = np.zeros((3, 8, 10, 12, 1), np.float32)
    mask = np.zeros((3, 8, 10, 12, 1), bool)
    exts = [(6, 8, 10), (8, 10, 12), (3, 4, 5)]
    for b, e in enumerate(exts):
        box = tuple(slice(1, 1 + s) if s < c else slice(0, s)
                    for s, c in zip(e, (8, 10, 12)))
        cache[(b, *box)] = rng.normal(0.5 * b, 1 + b, size=(*e, 1))
        mask[(b, *box)] = True
    count = np.array([np.prod(e) for e in exts], np.float32)
    g = _uniform(0.5, 1.6)
    ref = jax.vmap(lambda x, k, m, c: J.gamma(x, k, (0.5, 1.6), True, mask=m,
                                              count=c))(cache, KEYS, mask,
                                                        count)
    out = A.gamma(_t(cache), _t(g), True, mask=_t(mask), count=_t(count))
    _close(out.numpy(), ref)
    assert (out.numpy()[~mask] == 0).all()


def test_contrast_matches_jax_per_sample():
    img, _ = _batch()
    f = _uniform(0.65, 1.5)
    ref = jax.vmap(lambda x, k: J.contrast(x, k, (0.65, 1.5)))(img, KEYS)
    _close(A.contrast(_t(img), _t(f)).numpy(), ref)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_mirror_matches_jax_on_every_axis(axis):
    img, lab = _batch(C=2)
    ref_i, ref_l = jax.vmap(lambda x, y: J.mirror(x, y, axis))(img, lab)
    out_i, out_l = A.mirror(_t(img), _t(lab), axis)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))


def test_mirror_2d_matches_jax():
    img, lab = _batch(shape=(9, 11), C=1)
    for axis in (0, 1):
        ref_i, ref_l = jax.vmap(lambda x, y: J.mirror(x, y, axis))(img, lab)
        out_i, out_l = A.mirror(_t(img), _t(lab), axis)
        np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))


@pytest.mark.parametrize("rng_", [(0.5, 1.0), (0.5, 1.5)])
def test_gaussian_blur_matches_jax(rng_):
    img, _ = _batch(shape=(9, 10, 11))
    sigma = _uniform(*rng_)
    ref = jax.vmap(lambda x, k: J.gaussian_blur(x, k, rng_))(img, KEYS)
    out = A.gaussian_blur(_t(img), _t(sigma), rng_[1]).numpy()
    _close(out, ref, rel=1e-5)


@pytest.mark.parametrize("sigma", [np.float32(2.0 / 3.0), np.float32(1.0),
                                   np.float32(0.5)])
def test_gaussian_blur_at_a_support_boundary_matches_jax(sigma, monkeypatch):
    """3 sigma on an integer (ceil(3 sigma) = 3 sigma, fp32 2/3 gives 2 and
    1.0 gives 3) and off one (0.5: 1.5 -> 2), inside a support sized for
    1.5: the taps masked beyond ceil(3 sigma) and the 2D form."""
    img, _ = _batch(shape=(9, 10, 11))
    monkeypatch.setattr(J.jax.random, "uniform",
                        lambda *a, **k: jnp.float32(sigma))
    ref = jax.vmap(lambda x, k: J.gaussian_blur(x, k, (0.5, 1.5)))(img, KEYS)
    out = A.gaussian_blur(_t(img), torch.full((3,), float(sigma)), 1.5)
    _close(out.numpy(), ref, rel=1e-5)
    img2, _ = _batch(shape=(12, 13))
    ref2 = jax.vmap(lambda x, k: J.gaussian_blur(x, k, (0.5, 1.5)))(img2,
                                                                      KEYS)
    out2 = A.gaussian_blur(_t(img2), torch.full((3,), float(sigma)), 1.5)
    _close(out2.numpy(), ref2, rel=1e-5)


def test_blur_weights_mask_taps_beyond_three_sigma():
    w = A.blur_weights(torch.tensor([0.5, 1.0]), 1.5)
    assert w.shape == (2, 11)
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, rtol=1e-6)
    assert (w[0, :3] == 0).all() and (w[0, -3:] == 0).all()   # ceil(1.5)=2
    assert (w[1, :2] == 0).all() and (w[1, 2] > 0)             # ceil(3)=3


def test_std_range_noise_matches_jax_apply_op():
    """``gaussian_noise`` with ``std_range``: a per-sample std, then noise
    (pipeline.py:91-96), given the noise tensor."""
    img, lab = _batch()
    params = {"std_range": (0.0, 0.1)}
    ref = jax.vmap(lambda x, y, k: jax_apply_op(
        "gaussian_noise", params, x, y, k)[0])(img, lab, KEYS)
    k12 = jax.vmap(jax.random.split)(KEYS)
    std = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (), jnp.float32, 0.0, 0.1))(k12[:, 0]))
    noise = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, img.shape[1:], jnp.float32))(k12[:, 1]))
    out = A.add_noise(_t(img), _t(noise), _t(std)).numpy()
    _close(out, ref)


@pytest.mark.parametrize("grid,mag", [((4, 4, 4), (0.05, 0.05, 0.05)),
                                      ((3, 5, 4), (0.1, 0.02, 0.08))])
def test_elastic_3d_matches_jax(grid, mag):
    img, lab = _batch(shape=(10, 12, 14), C=2)
    disp = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (3, *grid), jnp.float32, -1.0, 1.0))(KEYS))
    ref_i, ref_l = jax.vmap(lambda x, y, k: J.elastic_deform_3d(
        x, y, k, grid=grid, magnitude=mag))(img, lab, KEYS)
    out_i, out_l = A.elastic_deform(_t(img), _t(lab), _t(disp), mag)
    _close(out_i.numpy(), ref_i, rel=1e-5)
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))


def test_elastic_field_matches_jax_resize():
    disp = np.random.default_rng(2).uniform(-1, 1, (3, 3, 4, 5)).astype(
        np.float32)
    # J._elastic_field draws its own control points: its resize, given them
    want = jax.image.resize(jnp.asarray(disp) * jnp.asarray(
        [0.1, 0.2, 0.3]).reshape(3, 1, 1, 1), (3, 11, 9, 13), method="linear")
    out = A.elastic_field(_t(disp[None]), (11, 9, 13), (0.1, 0.2, 0.3))[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_elastic_2d_matches_jax():
    img, lab = _batch(shape=(16, 18), C=1)
    grid, mag = (4, 4), (0.08, 0.05)
    disp = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (2, *grid), jnp.float32, -1.0, 1.0))(KEYS))
    ref_i, ref_l = jax.vmap(lambda x, y, k: J.elastic_deform_2d(
        x, y, k, grid=grid, magnitude=mag))(img, lab, KEYS)
    out_i, out_l = A.elastic_deform(_t(img), _t(lab), _t(disp), mag)
    _close(out_i.numpy(), ref_i, rel=1e-5)
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))


def test_zero_magnitude_elastic_is_the_identity():
    img, lab = _batch(shape=(5, 6, 7))
    disp = torch.rand(3, 3, 4, 4, 4) * 2 - 1
    out_i, out_l = A.elastic_deform(_t(img), _t(lab), disp, (0.0,) * 3)
    np.testing.assert_allclose(out_i.numpy(), img, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out_l.numpy(), lab)


def test_crops_match_jax():
    img, lab = _batch(shape=(10, 12, 14), C=2)
    crop = (6, 7, 9)
    ref_i, ref_l = jax.vmap(lambda x, y: J.center_crop_3d(x, y, crop))(img,
                                                                     lab)
    out_i, out_l = A.center_crop(_t(img), _t(lab), crop)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))

    def starts_of(k):
        kz, ky, kx = jax.random.split(k, 3)
        return jnp.stack([jax.random.randint(kk, (), 0, max(s - c, 1))
                          for kk, s, c in zip((kz, ky, kx), (10, 12, 14),
                                              crop)])
    starts = np.asarray(jax.vmap(starts_of)(KEYS))
    ref_i, ref_l = jax.vmap(lambda x, y, k: J.random_crop_3d(x, y, k, crop))(
        img, lab, KEYS)
    out_i, out_l = A.crop_at(_t(img), _t(lab), _t(starts), crop)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))

    img2, lab2 = _batch(shape=(11, 13))
    ref_i, ref_l = jax.vmap(lambda x, y: J.center_crop_2d(x, y, (6, 8)))(
        img2, lab2)
    out_i, out_l = A.center_crop(_t(img2), _t(lab2), (6, 8))
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))

    def starts2(k):
        ky, kx = jax.random.split(k)
        return jnp.stack([jax.random.randint(ky, (), 0, 11 - 6),
                          jax.random.randint(kx, (), 0, 13 - 8)])
    ref_i, ref_l = jax.vmap(lambda x, y, k: J.random_crop_2d(x, y, k, (6, 8)))(
        img2, lab2, KEYS)
    out_i, out_l = A.crop_at(_t(img2), _t(lab2),
                                    _t(np.asarray(jax.vmap(starts2)(KEYS))),
                                    (6, 8))
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))


@pytest.mark.parametrize("mode", ["random", "center"])
def test_crop_around_coordinate_matches_jax(mode):
    img, lab = _batch(shape=(12, 14, 16), C=1)
    crop = (6, 8, 5)
    points = np.array([[0, 13, 8], [11, 0, 15], [6, 7, 2]], np.int32)
    u = np.asarray(jax.vmap(lambda k: jnp.stack([
        jax.random.randint(kk, (), 0, 1 << 30)
        for kk in jax.random.split(k, 3)]))(KEYS))
    ref_i, ref_l = jax.vmap(lambda x, y, k, p: J.crop_around_coordinate_3d(
        x, y, k, crop, tuple(p[i] for i in range(3)), mode))(
        img, lab, KEYS, points)
    out_i, out_l = A.crop_around_coordinate_3d(_t(img), _t(lab), crop,
                                               _t(points), _t(u), mode)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))


def test_random_crop_starts_stay_in_range():
    st = A.random_crop_starts(torch.Generator().manual_seed(0), 4000,
                              (10, 12, 8), (6, 12, 3))
    assert st[:, 0].min() == 0 and st[:, 0].max() == 3     # high exclusive
    assert (st[:, 1] == 0).all()                            # max(0, 1)
    assert st[:, 2].max() == 4
    assert math.isclose(float(st[:, 0].float().mean()), 1.5, abs_tol=0.1)
