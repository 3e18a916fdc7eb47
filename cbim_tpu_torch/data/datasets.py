"""Datasets of the port (counterpart of ``cbim_tpu/data/datasets.py``).

Only the synthetic datasets are ported: ``Synthetic3D`` and
``Synthetic2D``, fabricated volumes with ellipsoid class regions, drawn from
the same numpy streams (``default_rng(1000 + name)`` and ``2000 + name``)
as the JAX package's, so the volumes are identical.  A re-implementation,
not an import: ``cbim_tpu.data.datasets`` imports its augmentation pipeline
and with it jax.  The other datasets (AMOS, BCV, LiTS, KiTS, ACDC 3D and
2D) and their recipes are queued in ROADMAP.md.
"""

from __future__ import annotations

import numpy as np

from .base import SliceDataset, VolumeDataset, kfold_split
from .pipeline import AugRecipe


def _synth_case(rng: np.random.Generator, shape, classes: int):
    """A blobby volume with ellipsoid class regions."""
    img = rng.normal(0, 0.3, size=shape).astype(np.float32)
    lab = np.zeros(shape, np.uint8)
    coords = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    for c in range(1, classes):
        center = [rng.uniform(0.25 * s, 0.75 * s) for s in shape]
        radii = [max(2.0, rng.uniform(0.08 * s, 0.2 * s)) for s in shape]
        dist = sum(((g - c0) / r0) ** 2 for g, c0, r0 in zip(coords, center, radii))
        mask = dist < 1.0
        lab[mask] = c
        img[mask] += 0.5 * c
    return img, lab


class Synthetic3D(VolumeDataset):
    """In-memory fabricated dataset for smoke tests and benchmarks."""

    def name_list(self, cfg, mode, k_fold, k, seed):
        n = int(cfg.get("synthetic_cases", 6))
        return kfold_split(list(range(n)), k_fold, k, seed, mode)

    def load_case(self, cfg, name):
        rng = np.random.default_rng(1000 + int(name))
        shape = tuple(cfg.get("synthetic_shape",
                              [int(t * 1.25) for t in cfg.training_size]))
        img, lab = _synth_case(rng, shape, cfg.classes)
        yield img, lab, (1.0, 1.0, 1.0)

    def preprocess(self, img, lab):
        return self.pad_to_training_size(img, lab)

    def recipe(self):
        cfg = self.cfg
        return AugRecipe(
            affine_prob=0.5, affine_pad=tuple(cfg.affine_pad_size),
            scale=cfg.scale, rotate=cfg.rotate, translate=cfg.translate,
            pre_ops=(("gaussian_noise", 1.0, {"std": cfg.gaussian_noise_std}),),
            post_ops=(("brightness_multiply", 0.2, {"range": (0.7, 1.3)}),))


class Synthetic2D(SliceDataset):
    """Fabricated (6, 1.25 H, 1.25 W) volumes, trained on as slices."""

    def name_list(self, cfg, mode, k_fold, k, seed):
        n = int(cfg.get("synthetic_cases", 6))
        return kfold_split(list(range(n)), k_fold, k, seed, mode)

    def load_case(self, cfg, name):
        rng = np.random.default_rng(2000 + int(name))
        hw = [int(t * 1.25) for t in cfg.training_size[:2]]
        shape = tuple(cfg.get("synthetic_shape", [6] + hw))
        img, lab = _synth_case(rng, shape, cfg.classes)
        yield img, lab, (1.0, 1.0, 1.0)

    def preprocess(self, img, lab):
        return img, lab

    def recipe(self):
        cfg = self.cfg
        return AugRecipe(
            affine_prob=1.0, affine_pad=tuple(cfg.affine_pad_size[:2]),
            scale=cfg.scale, rotate=cfg.rotate, translate=cfg.translate,
            pre_ops=(("gaussian_noise", 1.0, {"std": cfg.gaussian_noise_std}),))
