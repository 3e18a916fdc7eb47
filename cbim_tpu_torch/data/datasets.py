"""Datasets of the port (counterpart of ``cbim_tpu/data/datasets.py``): the
reference's datasets with their exact preprocessing constants, splits and
augmentation recipes (reference training/dataset/dim3/*.py,
dim2/dataset_acdc.py), and the synthetic ones.

- ``ACDC3D`` and ``ACDC2D``: cine MR, two frames (ED, ES) a case, the
  98th-percentile clip and scale, ACDC's pads (3D: +2 on every axis, floor
  halves, then a centre 256 crop in y/x; 2D: +10 in y/x); ACDC-3D's recipe
  runs its intensity ops and the affine over the full volume
  (``full_volume``);
- ``LiTS``, ``KiTS``, ``BCV``, ``AMOSCT`` (``_CTDataset``): a fixed HU
  window and z-score, the pad to the training size (+2 in y/x, ceil
  halves: ``PLUS2``); each with its crop-trick recipe (LiTS's third mirror
  gate re-flips axis 1, as the reference does); AMOS-CT has the
  reference's fixed 100-case test split and trains on every case;
- ``AMOSMR``: AMOS-CT's layout with a per-case 2/98-percentile clip and
  z-score, and its own 20-case test split;
- ``Synthetic3D`` and ``Synthetic2D``: fabricated volumes with ellipsoid
  class regions, drawn from the same numpy streams
  (``default_rng(1000 + name)`` and ``2000 + name``) as the JAX
  package's, so the volumes are identical.

The real datasets read the converted layout (``{name}.nii.gz``,
``{name}_gt.nii.gz`` and ``list/dataset.yaml`` under ``data_root``) that
``cbim_tpu_torch.data.conversion.convert`` writes.  A re-implementation,
not an import: ``cbim_tpu.data.datasets`` imports its augmentation
pipeline and with it jax.
"""

from __future__ import annotations

import os

import numpy as np

from .base import SliceDataset, VolumeDataset, kfold_split
from .pipeline import AugRecipe


def _cfg_affine(cfg):
    return dict(scale=cfg.scale, rotate=cfg.rotate, translate=cfg.translate)


def _read_pair(cfg, stem: str):
    """(img float32, lab uint8, spacing) of ``{stem}.nii.gz`` and
    ``{stem}_gt.nii.gz`` under ``data_root``."""
    from .nifti import read_nifti
    img = read_nifti(os.path.join(cfg.data_root, f"{stem}.nii.gz"))
    lab = read_nifti(os.path.join(cfg.data_root, f"{stem}_gt.nii.gz"))
    return img.data.astype(np.float32), lab.data.astype(np.uint8), img.spacing


def _intensity_pre_ops(cfg) -> tuple:
    """ACDC's always-on intensity ops before the affine
    (dataset_acdc.py:141-149)."""
    return (
        ("gaussian_noise", 1.0, {"std": cfg.gaussian_noise_std}),
        ("brightness_additive", 1.0, {"std": cfg.additive_brightness_std}),
        ("gamma", 1.0, {"range": tuple(cfg.gamma_range),
                        "retain_stats": True}),
    )


class ACDC3D(VolumeDataset):
    """reference training/dataset/dim3/dataset_acdc.py (CMRDataset)."""

    def load_case(self, cfg, name):
        for idx in (0, 1):                      # ED + ES frames per case
            yield _read_pair(cfg, f"{name}_{idx}")

    def preprocess(self, img, lab):
        """98th-pctile clip+scale, pad to >= training size (+2 quirk, floor
        halves), centre 256-crop in y/x (dataset_acdc.py:77-121)."""
        max98 = np.percentile(img, 98)
        img = np.clip(img, 0, max98)
        ts = self.cfg.training_size
        pads = []
        for ax in range(3):
            if img.shape[ax] < ts[ax]:
                diff = (ts[ax] + 2 - img.shape[ax]) // 2
                pads.append((diff, diff))
            else:
                pads.append((0, 0))
        if any(p != (0, 0) for p in pads):
            img = np.pad(img, pads)
            lab = np.pad(lab, pads)
        img = img / max98

        size = 256
        _, y, x = img.shape
        if y > size:
            img = img[:, y // 2 - size // 2:y // 2 + size // 2, :]
            lab = lab[:, y // 2 - size // 2:y // 2 + size // 2, :]
        if x > size:
            img = img[:, :, x // 2 - size // 2:x // 2 + size // 2]
            lab = lab[:, :, x // 2 - size // 2:x // 2 + size // 2]
        return img, lab

    def recipe(self):
        """dataset_acdc.py:141-149: intensity always-on before the affine
        over the FULL volume, then the random crop; no probability gates
        (exact on the device cache: pipeline.py's full-volume path)."""
        cfg = self.cfg
        return AugRecipe(
            affine_prob=1.0, affine_pad=tuple(cfg.affine_pad_size),
            **_cfg_affine(cfg), full_volume=True,
            pre_ops=_intensity_pre_ops(cfg))


class ACDC2D(SliceDataset):
    """reference training/dataset/dim2/dataset_acdc.py (CMRDataset)."""

    def load_case(self, cfg, name):
        for idx in (0, 1):
            yield _read_pair(cfg, f"{name}_{idx}")

    def preprocess(self, img, lab):
        """98th-pctile clip+scale, pad y/x to >= training_size (+10 quirk)
        (dim2 dataset_acdc.py:92-117)."""
        max98 = np.percentile(img, 98)
        img = np.clip(img, 0, max98)
        ts = self.cfg.training_size
        _, y, x = img.shape
        if x < ts[0]:
            diff = (ts[0] + 10 - x) // 2
            img = np.pad(img, ((0, 0), (0, 0), (diff, diff)))
            lab = np.pad(lab, ((0, 0), (0, 0), (diff, diff)))
        if y < ts[1]:
            diff = (ts[1] + 10 - y) // 2
            img = np.pad(img, ((0, 0), (diff, diff), (0, 0)))
            lab = np.pad(lab, ((0, 0), (diff, diff), (0, 0)))
        img = img / max98
        return img, lab

    def recipe(self):
        cfg = self.cfg
        pad = cfg.affine_pad_size[:2] if len(cfg.affine_pad_size) >= 2 \
            else (0, 0)
        return AugRecipe(
            affine_prob=1.0, affine_pad=tuple(pad), **_cfg_affine(cfg),
            pre_ops=_intensity_pre_ops(cfg))


class _CTDataset(VolumeDataset):
    """Shared skeleton of the CT datasets: a fixed window and z-score."""
    CLIP = (0.0, 1.0)
    MEAN = 0.0
    STD = 1.0
    PLUS2 = (0, 2, 2)

    def preprocess(self, img, lab):
        img = np.clip(img, *self.CLIP)
        img = (img - self.MEAN) / self.STD
        return self.pad_to_training_size(img, lab, self.PLUS2)


class _IntNamed(_CTDataset):
    """Cases named by integers: ``{int(name)}.nii.gz``."""

    def load_case(self, cfg, name):
        yield _read_pair(cfg, str(int(name)))


class LiTS(_IntNamed):
    """dataset_lits.py: clip [-17, 201], mu 99.40, sigma 39.39."""
    CLIP = (-17, 201)
    MEAN = 99.40
    STD = 39.39

    def recipe(self):
        """dataset_lits.py:110-152: crop trick p=0.2 pad 70, gates 0.15/0.3.

        The reference's third mirror gate re-flips axis 1 with p=0.05
        (dataset_lits.py:148-150), reproduced as it is."""
        cfg = self.cfg
        return AugRecipe(
            affine_prob=0.2, affine_pad=(70, 70, 70), **_cfg_affine(cfg),
            post_ops=(
                ("gaussian_noise", 0.15, {"std_range": (0.0, 0.1)}),
                ("brightness_multiply", 0.15, {"range": (0.7, 1.3)}),
                ("gamma", 0.15, {"range": (0.7, 1.5)}),
                ("contrast", 0.15, {"range": (0.65, 1.5)}),
                ("mirror", 0.3, {"axis": 2}),
                ("mirror", 0.2, {"axis": 1}),
                ("mirror", 0.05, {"axis": 1}),
            ))


class KiTS(_IntNamed):
    """dataset_kits.py: clip [-79, 304], mu 100.93, sigma 76.90."""
    CLIP = (-79, 304)
    MEAN = 100.93
    STD = 76.90

    def recipe(self):
        cfg = self.cfg
        return AugRecipe(
            affine_prob=0.2, affine_pad=(60, 60, 60), **_cfg_affine(cfg),
            post_ops=(
                ("brightness_multiply", 0.2, {"range": (0.7, 1.3)}),
                ("gamma", 0.2, {"range": (0.7, 1.5)}),
                ("contrast", 0.2, {"range": (0.65, 1.5)}),
                ("mirror", 0.3, {"axis": 2}),
                ("mirror", 0.3, {"axis": 1}),
                ("mirror", 0.3, {"axis": 0}),
                ("gaussian_blur", 0.2, {"range": (0.5, 1.0)}),
                ("gaussian_noise", 0.2, {"std_range": (0.0, 0.1)}),
            ))


class BCV(_CTDataset):
    """dataset_bcv.py: clip [-958, 327], mu 82.92, sigma 136.97; cases read
    by the base's ``{name}.nii.gz``."""
    CLIP = (-958, 327)
    MEAN = 82.92
    STD = 136.97

    def recipe(self):
        cfg = self.cfg
        return AugRecipe(
            affine_prob=0.5, affine_pad=(15, 65, 65), **_cfg_affine(cfg),
            post_ops=(
                ("brightness_multiply", 0.2, {"range": (0.7, 1.3)}),
                ("brightness_additive", 0.2, {"std": 0.1}),
                ("gamma", 0.2, {"range": (0.7, 1.5)}),
                ("contrast", 0.2, {"range": (0.7, 1.3)}),
                ("gaussian_blur", 0.2, {"range": (0.5, 1.0)}),
                ("gaussian_noise", 0.2, {"std_range": (0.0, 0.1)}),
            ))


class AMOSCT(_IntNamed):
    """dataset_amos_ct.py: clip [-991, 362], mu 50, sigma 141; fixed test
    split."""
    CLIP = (-991, 362)
    MEAN = 50.0
    STD = 141.0
    PLUS2 = (0, 2, 2)

    #: dataset_amos_ct.py:37 — hard-coded 100-case test split
    TEST_SPLIT = [13, 70, 292, 280, 29, 334, 257, 357, 326, 191, 238, 310, 373,
                  202, 247, 255, 228, 328, 363, 200, 56, 144, 290, 308, 208,
                  316, 216, 204, 304, 85, 189, 140, 40, 123, 286, 176, 284,
                  150, 117, 174, 206, 218, 318, 365, 377, 87, 372, 311, 203,
                  356, 339, 244, 344, 90, 293, 128, 155, 136, 63, 112, 34, 283,
                  157, 73, 61, 313, 325, 258, 409, 346, 106, 18, 22, 41, 287,
                  399, 333, 233, 250, 342, 309, 278, 223, 323, 194, 352, 364,
                  219, 207, 368, 8, 108, 167, 51, 132, 385, 32, 289, 397, 120]

    def name_list(self, cfg, mode, k_fold, k, seed):
        """The fixed test split; training takes ALL cases of
        ``list/dataset.yaml`` (the reference's), in a seeded shuffle."""
        if mode == "test":
            return list(self.TEST_SPLIT)
        import random
        import yaml
        with open(os.path.join(cfg.data_root, "list", "dataset.yaml")) as f:
            names = yaml.safe_load(f)
        random.Random(seed).shuffle(names)
        return names

    def recipe(self):
        cfg = self.cfg
        return AugRecipe(
            affine_prob=0.5, affine_pad=tuple(cfg.affine_pad_size),
            **_cfg_affine(cfg),
            post_ops=(
                ("brightness_multiply", 0.2, {"range": (0.7, 1.3)}),
                ("brightness_additive", 0.2, {"std": 0.1}),
                ("gamma", 0.2, {"range": (0.7, 1.5)}),
                ("contrast", 0.2, {"range": (0.7, 1.3)}),
                ("gaussian_blur", 0.2, {"range": (0.5, 1.5)}),
                ("gaussian_noise", 0.2, {"std_range": (0.0, 0.1)}),
            ))


class AMOSMR(AMOSCT):
    """dataset_amos_mr.py: per-case 2/98-percentile clip + z-score."""

    TEST_SPLIT = [553, 575, 598, 559, 547, 563, 549, 545, 573, 561, 552, 568,
                  576, 550, 562, 546, 572, 556, 544, 581]

    def preprocess(self, img, lab):
        p2 = np.percentile(img, 2, axis=None)
        p98 = np.percentile(img, 98, axis=None)
        img = np.clip(img, p2, p98)
        img = (img - np.mean(img)) / np.std(img)
        return self.pad_to_training_size(img, lab, (0, 2, 2))

    def recipe(self):
        cfg = self.cfg
        return AugRecipe(
            affine_prob=0.4, affine_pad=tuple(cfg.affine_pad_size),
            **_cfg_affine(cfg),
            post_ops=(
                ("brightness_multiply", 0.2, {"range": (0.7, 1.3)}),
                ("brightness_additive", 0.2, {"std": 0.2}),
                ("gamma", 0.2, {"range": (0.7, 1.5)}),
                ("contrast", 0.2, {"range": (0.7, 1.3)}),
                ("gaussian_blur", 0.2, {"range": (0.5, 1.5)}),
                ("gaussian_noise", 0.2, {"std_range": (0.0, 0.2)}),
            ))


# ---------------------------------------------------------------------------
# synthetic data (no files needed): smoke tests, CI, and benchmarking
# ---------------------------------------------------------------------------

def _synth_case(rng: np.random.Generator, shape, classes: int):
    """A blobby volume with ellipsoid class regions.  Each region's
    distances are evaluated in its bounding box only: the voxels outside
    lie more than a radius from the centre on some axis, so the labels and
    values are those of the whole-grid evaluation, at a fraction of its
    cost (15 regions of a 192^3 volume)."""
    img = rng.normal(0, 0.3, size=shape).astype(np.float32)
    lab = np.zeros(shape, np.uint8)
    for c in range(1, classes):
        center = [rng.uniform(0.25 * s, 0.75 * s) for s in shape]
        radii = [max(2.0, rng.uniform(0.08 * s, 0.2 * s)) for s in shape]
        box = tuple(slice(max(0, int(np.floor(c0 - r0))),
                          min(s, int(np.ceil(c0 + r0)) + 1))
                    for c0, r0, s in zip(center, radii, shape))
        coords = np.meshgrid(*[np.arange(b.start, b.stop) for b in box],
                             indexing="ij")
        dist = sum(((g - c0) / r0) ** 2
                   for g, c0, r0 in zip(coords, center, radii))
        mask = dist < 1.0
        lab[box][mask] = c
        img[box][mask] += 0.5 * c
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
            **_cfg_affine(cfg),
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
            **_cfg_affine(cfg),
            pre_ops=(("gaussian_noise", 1.0, {"std": cfg.gaussian_noise_std}),))
