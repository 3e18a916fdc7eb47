"""Dataset base machinery (counterpart of ``cbim_tpu/data/base.py``):
k-fold splits and the host RAM cache of preprocessed volumes (3D) or of
their slices (2D).

A re-implementation, not an import: the port imports nothing of
``cbim_tpu``.  PyYAML is imported inside :meth:`VolumeDataset.name_list`
only (the converted layout's ``list/dataset.yaml``), so the synthetic
datasets need no YAML parser.  ``tests/test_torch_train.py`` and
``tests/test_torch_datasets.py`` hold the two packages equal.
"""

from __future__ import annotations

import logging
import math
import os
import random

import numpy as np


def kfold_split(names: list, k_fold: int, k: int, seed: int, mode: str) -> list:
    """Seeded-shuffle k-fold split (reference dataset_acdc.py:29-38): test
    is the contiguous slice k of the shuffled list, train the rest (in
    shuffled order)."""
    names = list(names)
    random.Random(seed).shuffle(names)
    n = len(names)
    test = names[k * (n // k_fold):(k + 1) * (n // k_fold)]
    if mode == "train":
        test_set = set(test)
        return [x for x in names if x not in test_set]
    return test


class VolumeDataset:
    """Base for 3D datasets: every case of the split, preprocessed, in host
    RAM (images float32, labels int8, spacings float64)."""

    dimension = "3d"

    def __init__(self, cfg, mode: str = "train", k_fold: int = 5, k: int = 0,
                 seed: int = 0):
        assert mode in ("train", "test")
        self.cfg = cfg
        self.mode = mode
        names = self.name_list(cfg, mode, k_fold, k, seed)
        logging.info("Start loading %s data (%d cases)", mode, len(names))
        self.images: list[np.ndarray] = []
        self.labels: list[np.ndarray] = []
        self.spacings: list[np.ndarray] = []
        for name in names:
            for img, lab, spacing in self.load_case(cfg, name):
                img, lab = self.preprocess(img, lab)
                self.images.append(np.ascontiguousarray(img, dtype=np.float32))
                self.labels.append(np.ascontiguousarray(lab, dtype=np.int8))
                self.spacings.append(np.asarray(spacing, dtype=np.float64))
        logging.info("Load done, length of dataset: %d", len(self.images))

    def name_list(self, cfg, mode, k_fold, k, seed):
        """The case names of ``list/dataset.yaml`` under ``data_root`` (the
        layout ``data/conversion/convert.py`` writes), k-fold split."""
        import yaml
        with open(os.path.join(cfg.data_root, "list", "dataset.yaml")) as f:
            names = yaml.safe_load(f)
        return kfold_split(names, k_fold, k, seed, mode)

    def load_case(self, cfg, name):
        """Yield (img_zyx, lab_zyx, spacing_zyx) of one case:
        ``{name}.nii.gz`` and ``{name}_gt.nii.gz``."""
        from .nifti import read_nifti
        img = read_nifti(os.path.join(cfg.data_root, f"{name}.nii.gz"))
        lab = read_nifti(os.path.join(cfg.data_root, f"{name}_gt.nii.gz"))
        assert img.data.shape == lab.data.shape, name
        yield img.data.astype(np.float32), lab.data.astype(np.uint8), img.spacing

    def preprocess(self, img, lab):
        raise NotImplementedError

    def recipe(self):
        raise NotImplementedError

    def pad_to_training_size(self, img, lab, plus2: tuple = (0, 2, 2)):
        """The reference's per-axis pad when smaller than training_size:
        y/x to training_size + 2, z to training_size, ceil-half per side
        (dataset_lits.py:81-93)."""
        ts = self.cfg.training_size
        pads = []
        for ax in range(3):
            if img.shape[ax] < ts[ax]:
                diff = int(math.ceil((ts[ax] + plus2[ax] - img.shape[ax]) / 2))
                pads.append((diff, diff))
            else:
                pads.append((0, 0))
        if any(p != (0, 0) for p in pads):
            img = np.pad(img, pads)
            lab = np.pad(lab, pads)
        return img, lab

    def __len__(self):
        return len(self.images)

    def test_item(self, idx):
        """(img, lab, spacing) of test volume ``idx``, the validation's
        input."""
        return self.images[idx], self.labels[idx], self.spacings[idx]


class SliceDataset(VolumeDataset):
    """Base for 2D datasets: the volumes load as in 3D, and in train mode
    each is split into its z slices, the samples the 2D pipeline draws; in
    test mode the volumes stay whole, for validation
    (reference training/dataset/dim2/dataset_acdc.py:66-90)."""

    dimension = "2d"

    def __init__(self, cfg, mode="train", k_fold=5, k=0, seed=0):
        super().__init__(cfg, mode, k_fold, k, seed)
        if mode == "train":
            self.images = [np.ascontiguousarray(s) for img in self.images
                           for s in img]
            self.labels = [np.ascontiguousarray(s) for lab in self.labels
                           for s in lab]

    def test_item(self, idx):
        """Whole volume, centre-cropped in y/x to the training size where it
        is at least that large (dim2 dataset_acdc.py:154-166)."""
        img, lab = self.images[idx], self.labels[idx]
        th, tw = self.cfg.training_size[:2]
        y = (img.shape[1] - th) // 2
        x = (img.shape[2] - tw) // 2
        if y >= 0 and x >= 0:
            img = img[:, y:y + th, x:x + tw]
            lab = lab[:, y:y + th, x:x + tw]
        return img, lab, self.spacings[idx]
