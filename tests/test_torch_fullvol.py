"""The device cache and the full-volume path of the port's pipeline against
``cbim_tpu``'s ``TrainPipeline``, on the CPU.

The full-volume resample is held against the JAX function on a padded
cache of different extents (image 1e-5 of max|ref|, labels exactly); the
cache's margins, shape and window starts against the JAX pipeline's for the
same seed (the same numpy calls in the same order); an identity recipe
(affine_prob 0, no ops) gives the JAX pipeline's batches bit for bit (bf16
cache, both paths); and each dataset recipe's per-sample gates fire at
their probabilities within binomial bounds (the PRNG streams differ, ROADMAP
C5, so the gates are held in distribution).  A gated op changes exactly the
samples its gate takes, image and label together, and the recipe's class
count bounds the int8 label cache.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.data import datasets as JD
from cbim_tpu.data import pipeline as JP
from cbim_tpu.ops import augment as J
from cbim_tpu.ops.resample import \
    affine_sample_3d_fullvol_batch as jax_fullvol
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data import datasets as TD
from cbim_tpu_torch.data import pipeline as TP
from cbim_tpu_torch.ops.resample import affine_sample_3d_fullvol_batch
from test_torch_threads import few_torch_threads  # noqa: F401

#: volumes of different extents: smaller and larger than the buffer
SHAPES = [(10, 26, 30), (14, 20, 22), (9, 31, 24), (12, 24, 27),
          (11, 22, 33)]
SHAPES_2D = [(2, 26, 30), (2, 19, 23), (2, 31, 24)]


def _varied(base, pkg_recipe, shapes):
    """A dataset of ``base`` (Synthetic3D/2D of either package) whose cases
    have the given shapes and the recipe ``pkg_recipe(cfg)``."""
    class Varied(base):
        def load_case(self, cfg, name):
            rng = np.random.default_rng(50 + int(name))
            shape = shapes[int(name) % len(shapes)]
            img = rng.normal(size=shape).astype(np.float32)
            lab = rng.integers(0, 4, size=shape).astype(np.uint8)
            yield img, lab, (1.0, 1.0, 1.0)

        def preprocess(self, img, lab):
            return img, lab

        def recipe(self):
            return pkg_recipe(self.cfg)
    return Varied


def _cfg(dim="3d", **kw):
    d = dict(dataset="synthetic", model="medformer", dimension=dim,
             classes=4, training_size=[8, 16, 16] if dim == "3d" else [16, 16],
             synthetic_cases=len(SHAPES) if dim == "3d" else len(SHAPES_2D),
             k_fold=5, split_seed=0, device_cache=True)
    d.update(kw)
    return d


def _pipes(d, recipe_kw, seed=3):
    jc, tc = jax_config(d), config_from_dict(d)
    three = d["dimension"] == "3d"
    shapes = SHAPES if three else SHAPES_2D
    jbase = JD.Synthetic3D if three else JD.Synthetic2D
    tbase = TD.Synthetic3D if three else TD.Synthetic2D
    jds = _varied(jbase, lambda c: JP.AugRecipe(**recipe_kw), shapes)(jc)
    tds = _varied(tbase, lambda c: TP.AugRecipe(**recipe_kw), shapes)(tc)
    return (JP.TrainPipeline(jds, jc, seed=seed),
            TP.TrainPipeline(tds, tc, seed=seed, device="cpu"))


def test_fullvol_resample_matches_jax_on_a_padded_cache():
    """Grid over each sample's true extent, coordinates in cache voxels
    offset by the margin, crop start in volume coordinates, zeros outside."""
    rng = np.random.default_rng(0)
    cache, place, crop = (14, 30, 34), np.array([2, 3, 1]), (6, 12, 16)
    exts = np.array([[8, 20, 24], [12, 26, 32], [9, 27, 30]], np.int32)
    img = np.zeros((3, *cache, 1), np.float32)
    lab = np.zeros((3, *cache), np.int8)
    for b, e in enumerate(exts):
        box = tuple(slice(p, p + s) for p, s in zip(place, e))
        img[(b, *box)] = rng.normal(size=(*e, 1))
        lab[(b, *box)] = rng.integers(0, 5, size=e)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    theta = np.array(jax.vmap(lambda k: J.random_theta_3d(
        k, (0.3, 0.3, 0.3), (30, 20, 20), (0.1, 0.1, 0.1),
        (0.05,) * 3))(keys))
    theta[0] = np.eye(3, 4)                     # identity: a plain crop
    offs = np.array([[0, 3, 5], [4, 14, 16], [2, 0, 13]], np.int32)
    ref_i, ref_l = jax_fullvol(jnp.asarray(img), jnp.asarray(lab),
                               jnp.asarray(theta), jnp.asarray(exts),
                               jnp.asarray(offs), place, crop, num_classes=5)
    out_i, out_l = affine_sample_3d_fullvol_batch(
        torch.from_numpy(img), torch.from_numpy(lab), torch.from_numpy(theta),
        torch.from_numpy(exts), torch.from_numpy(offs),
        torch.from_numpy(place), crop)
    assert out_i.shape == (3, *crop, 1) and out_l.dtype == torch.int8
    ref_i = np.asarray(ref_i)
    np.testing.assert_allclose(out_i.numpy(), ref_i, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_i).max())
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))
    # the identity sample is the crop of the true volume at its offset
    box = tuple(slice(p + o, p + o + c) for p, o, c in zip(place, offs[0],
                                                           crop))
    np.testing.assert_allclose(out_i[0].numpy(), img[(0, *box)], atol=1e-5)


def test_fullvol_resample_labels_at_half_voxel_ties_match_jax():
    """A scale of exactly 2 over an odd extent puts samples on .5 ties:
    rounding half to even on both sides, labels identical."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 9, 11, 13, 1)).astype(np.float32)
    lab = rng.integers(0, 7, size=(2, 9, 11, 13)).astype(np.int8)
    theta = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1)) * 0.5
    theta[:, :, 3] = [0.0, 0.25, -0.25]
    exts = np.array([[9, 11, 13], [7, 9, 11]], np.int32)
    offs = np.array([[0, 0, 0], [1, 2, 0]], np.int32)
    ref_i, ref_l = jax_fullvol(jnp.asarray(img), jnp.asarray(lab),
                               jnp.asarray(theta), jnp.asarray(exts),
                               jnp.asarray(offs), np.zeros(3, np.int32),
                               (5, 7, 9), num_classes=7)
    out_i, out_l = affine_sample_3d_fullvol_batch(
        torch.from_numpy(img), torch.from_numpy(lab), torch.from_numpy(theta),
        torch.from_numpy(exts), torch.from_numpy(offs), torch.zeros(3),
        (5, 7, 9))
    np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))
    np.testing.assert_allclose(out_i.numpy(), np.asarray(ref_i), atol=1e-5)


@pytest.mark.parametrize("fullvol", [False, True])
def test_device_cache_margins_shape_and_starts_match_jax(fullvol):
    d = _cfg(full_volume=fullvol)
    j_pipe, t_pipe = _pipes(d, dict(affine_prob=0.0, affine_pad=(4, 8, 8),
                                    full_volume=fullvol))
    assert t_pipe.fullvol == j_pipe._fullvol == fullvol
    np.testing.assert_array_equal(t_pipe.cache_margin, j_pipe._cache_margin)
    assert tuple(t_pipe.cache_img.shape) == tuple(j_pipe._cache_img.shape)
    assert t_pipe.cache_img.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t_pipe.cache_img.float().numpy(),
        np.asarray(j_pipe._cache_img.astype(jnp.float32)))
    np.testing.assert_array_equal(t_pipe.cache_lab.numpy(),
                                  np.asarray(j_pipe._cache_lab))

    seen = []

    def record(cache_img, cache_lab, idxs, starts, keys):
        seen.append((np.asarray(idxs), np.asarray(starts)))
        B = idxs.shape[0]
        return (jnp.zeros((B, *j_pipe.crop_size, 1)),
                jnp.zeros((B, *j_pipe.crop_size), jnp.int32))

    j_pipe._device_cache = record
    for _ in range(4):
        j_pipe.next_batch(3)
        idxs = t_pipe._draw_indices(3)
        starts = t_pipe._cache_starts(idxs)
        np.testing.assert_array_equal(idxs, seen[-1][0])
        np.testing.assert_array_equal(starts, seen[-1][1])


#: (dimension, full_volume, affine pad, exact): the window paths' buffers
#: at 2^k + 1 voxels an axis (17 = 16 + 1, 17 = 8 + 9) put every normalised
#: grid point -1 + 2 i / 2^k exactly in fp32, so the identity affine is an
#: exact crop in both packages; at other extents the two packages round the
#: normalised grid differently (jnp.linspace vs F.affine_grid): an ulp of
#: a coordinate weighs the neighbour's difference, within the resample's
#: tolerance (1e-5 of max|ref|) and a bf16 ulp (2^-7) in a few voxels.  The full-volume grid is the same
#: formula in both (resample.affine_coords_3d_fullvol), exact at any extent.
IDENTITY_CASES = [("3d", False, (9, 1, 1), True), ("3d", False, (4, 8, 8), False),
                  ("3d", True, (4, 8, 8), True), ("2d", False, (1, 1), True),
                  ("2d", False, (6, 4), False)]


@pytest.mark.parametrize("dim,fullvol,pad,exact", IDENTITY_CASES)
def test_identity_recipe_batches_equal_jax(dim, fullvol, pad, exact):
    """affine_prob 0 and no ops: the device cache's windows (or the
    full-volume crops) through an identity affine, the JAX pipeline's
    batches (bf16 cache on both): exactly, or within the resample's
    tolerance where the grid itself rounds (IDENTITY_CASES)."""
    kw = dict(affine_prob=0.0, full_volume=fullvol, affine_pad=pad)
    if dim == "2d":            # random_theta_2d takes a scalar rotation
        kw.update(scale=0.3, rotate=30, translate=0.0)
    j_pipe, t_pipe = _pipes(_cfg(dim, full_volume=fullvol), kw)
    assert t_pipe.cache_img is not None and t_pipe.fullvol == fullvol
    for _ in range(3):
        j_img, j_lab = j_pipe.next_batch(4)
        t_img, t_lab = t_pipe.next_batch(4)
        assert t_img.dtype == torch.float32 and t_lab.dtype == torch.int64
        j_img = np.asarray(j_img.astype(jnp.float32))
        np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))
        if exact:
            np.testing.assert_array_equal(t_img.numpy(), j_img)
        else:
            np.testing.assert_allclose(t_img.numpy(), j_img, rtol=2 ** -7,
                                       atol=1e-5 * np.abs(j_img).max())
            assert (t_img.numpy() != j_img).mean() < 1e-3


def test_device_cache_rule_matches_jax():
    """``auto`` takes the cache when n x cache voxels x 5 bytes fits
    ``device_cache_bytes``; false (or a smaller limit) keeps host windows;
    ``cache_dtype`` float32 opts out of bf16."""
    for kw, want in ((dict(), True), (dict(device_cache="auto"), True),
                     (dict(device_cache=False), False),
                     (dict(device_cache="auto", device_cache_bytes=1000),
                      False),
                     (dict(device_cache=True, device_cache_bytes=1000),
                      True)):
        d = dict(_cfg(), **kw)
        if not kw:
            d.pop("device_cache")
        j_pipe, t_pipe = _pipes(d, dict(affine_pad=(4, 8, 8)))
        assert (t_pipe.cache_img is not None) == want
        assert (j_pipe._device_cache is not None) == want
    _, t_pipe = _pipes(_cfg(cache_dtype="float32"), dict(affine_pad=(4, 8, 8)))
    assert t_pipe.cache_img.dtype == torch.float32
    with pytest.raises(ValueError, match="mask-unsafe"):
        _pipes(_cfg(), dict(affine_pad=(4, 8, 8), full_volume=True,
                            pre_ops=(("gaussian_blur", 1.0,
                                      {"range": (0.5, 1.0)}),)))


def _recipe(cls, cfg):
    return cls.recipe(SimpleNamespace(cfg=cfg))


@pytest.mark.parametrize("cls", [TD.LiTS, TD.KiTS, TD.BCV, TD.AMOSCT,
                                 TD.AMOSMR, TD.ACDC3D])
def test_recipe_gates_fire_at_their_probabilities(cls, monkeypatch):
    """Every gated op of the recipe, and the affine branch, fires for a
    sample with its probability: over 1536 samples each count lies within 5
    standard deviations of n p (fixed seeds; the JAX package's streams
    differ, so its gates are matched in distribution)."""
    cfg = config_from_dict(dict(_cfg(), scale=[0.3] * 3, rotate=[30] * 3,
                                translate=[0] * 3, affine_pad_size=[2] * 3,
                                gaussian_noise_std=0.02,
                                additive_brightness_std=0.5,
                                gamma_range=[0.7, 1.5]))
    from dataclasses import replace
    recipe = replace(_recipe(cls, cfg), affine_pad=(2, 2, 2))
    gated = [p for (_, p, _) in recipe.pre_ops if p < 1.0]
    if recipe.affine_prob < 1.0:
        gated.append(recipe.affine_prob)
    gated += [p for (_, p, _) in recipe.post_ops if p < 1.0]
    draws = []
    real = TP._draw_gate

    def record(gen, n, prob):
        take = real(gen, n, prob)
        draws.append((prob, take))
        return take

    monkeypatch.setattr(TP, "_draw_gate", record)
    fn = TP.build_batch_aug(recipe, (4, 4, 4))
    gen_host = torch.Generator().manual_seed(0)
    gen_dev = torch.Generator().manual_seed(0)
    B, n_batches = 64, 24
    rng = np.random.default_rng(0)
    for _ in range(n_batches):
        img = torch.from_numpy(rng.normal(size=(B, 6, 6, 6, 1)).astype(
            np.float32))
        lab = torch.from_numpy(rng.integers(0, 3, size=(B, 6, 6, 6)))
        fn(img, lab, gen_host, gen_dev)
    assert len(draws) == len(gated) * n_batches
    n = B * n_batches
    for i, p in enumerate(gated):
        mine = draws[i::len(gated)]
        assert all(q == p for q, _ in mine)
        k = int(sum(int(t.sum()) for _, t in mine))
        assert abs(k - n * p) <= 5 * np.sqrt(n * p * (1 - p)), (i, p, k, n)


#: one gated op of each kind: the mirror on every axis (image and label),
#: the intensity ops (image only) and the elastic (both, resampled)
GATED_OPS = [("mirror", {"axis": 0}), ("mirror", {"axis": 1}),
             ("mirror", {"axis": 2}), ("contrast", {"range": (0.65, 1.5)}),
             ("gamma", {"range": (0.7, 1.5)}),
             ("gaussian_blur", {"range": (0.5, 1.0)}),
             ("brightness_additive", {"std": 0.5}),
             ("gaussian_noise", {"std_range": (0.05, 0.1)}),
             ("elastic", {"grid": (3, 3, 3), "magnitude": (0.3,) * 3})]


@pytest.mark.parametrize("name,params", GATED_OPS,
                         ids=[f"{n}{p.get('axis', '')}" for n, p in GATED_OPS])
def test_gate_keeps_off_samples_and_moves_image_and_label_together(
        name, params, monkeypatch):
    """Behind a Bernoulli(0.5) gate an op leaves the gate-off samples'
    image and label bit for bit, and gives the gate-on samples the ungated
    op's output (same draws: the gate is drawn first), image and label of
    the same samples: a gated mirror flips both, an intensity op keeps
    every label."""
    rng = np.random.default_rng(3)
    B = 8
    img = torch.from_numpy(rng.normal(size=(B, 6, 7, 8, 1)).astype(
        np.float32))
    lab = torch.from_numpy(rng.integers(0, 4, size=(B, 6, 7, 8)))
    gates = []
    real = TP._draw_gate

    def record(gen, n, prob):
        gates.append(real(gen, n, prob))
        return gates[-1]

    monkeypatch.setattr(TP, "_draw_gate", record)
    out_i, out_l = TP._gated(name, 0.5, params, img, lab,
                             torch.Generator().manual_seed(5),
                             torch.Generator().manual_seed(5))
    take, = gates
    assert take.any() and not take.all(), take
    gen_host = torch.Generator().manual_seed(5)
    real(gen_host, B, 0.5)
    ref_i, ref_l = TP._apply_op(name, params, img, lab, gen_host,
                                torch.Generator().manual_seed(5))
    off = ~take
    assert torch.equal(out_i[off], img[off])
    assert torch.equal(out_l[off], lab[off])
    assert torch.equal(out_i[take], ref_i[take])
    assert torch.equal(out_l[take], ref_l[take])
    assert not torch.equal(out_i[take], img[take])
    if name == "mirror":
        axis = params["axis"] + 1
        assert torch.equal(out_i[take], img[take].flip(axis))
        assert torch.equal(out_l[take], lab[take].flip(axis))
    elif name != "elastic":
        assert torch.equal(out_l, lab)


def test_label_ids_beyond_the_int8_cache_raise():
    """``AugRecipe.num_classes`` (the config's ``classes`` by default)
    bounds the label ids that the int8 cache and host windows hold."""
    with pytest.raises(ValueError, match="int8"):
        _pipes(_cfg(classes=129), dict(affine_pad=(4, 8, 8)))
    _, t_pipe = _pipes(_cfg(classes=128), dict(affine_pad=(4, 8, 8)))
    assert t_pipe.recipe.num_classes == 128
    with pytest.raises(ValueError, match="int8"):
        _pipes(_cfg(), dict(affine_pad=(4, 8, 8), num_classes=300))
