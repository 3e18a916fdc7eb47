"""The port's dataset readers against ``cbim_tpu.data``'s, on the CPU.

For each dataset of the JAX registry, tiny NIfTI cases and
``list/dataset.yaml`` are written in the converted layout, then read
through both packages' ``get_dataset``: the name lists, the preprocessed
images (1e-6 relative), labels and spacings are equal, and so are the
recipes, op for op.  Then a narrow MedFormer-3D takes a train step on a
written KiTS corpus and a narrow MedFormer-2D on an ACDC-2D one, through
the port's ``train_net`` on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import yaml

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.data import datasets as JD
from cbim_tpu.data.factory import get_dataset as jax_get_dataset
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data import datasets as TD
from cbim_tpu_torch.data.factory import get_dataset
from cbim_tpu_torch.data.nifti import write_nifti
from cbim_tpu_torch.training.trainer import train_net
from test_torch_medformer import TINY
from test_torch_train2d import TRAIN2D
from test_torch_threads import few_torch_threads  # noqa: F401

#: the recipe keys every dataset config carries
RECIPE_KEYS = dict(scale=[0.3, 0.3, 0.3], rotate=[30, 30, 30],
                   translate=[0, 0, 0], affine_pad_size=[4, 8, 8],
                   gaussian_noise_std=0.02, additive_brightness_std=0.7,
                   gamma_range=[0.5, 1.6], k_fold=3, split_seed=1,
                   classes=4)


def _write(root, stem, shape, rng, mr=False, classes=4,
           spacing=(2.5, 0.8, 0.8)):
    """One case: CT-like int16 HU (or non-negative MR-like float) and a
    label map."""
    if mr:
        img = np.abs(rng.normal(300, 120, size=shape)).astype(np.float32)
    else:
        img = rng.normal(40, 300, size=shape).clip(-1024, 3000).astype(
            np.int16)
    lab = rng.integers(0, classes, size=shape).astype(np.uint8)
    write_nifti(root / f"{stem}.nii.gz", img, spacing)
    write_nifti(root / f"{stem}_gt.nii.gz", lab, spacing)


def _names(root, names):
    (root / "list").mkdir(parents=True, exist_ok=True)
    with open(root / "list" / "dataset.yaml", "w") as f:
        yaml.dump(names, f)


#: dataset -> (dimension, training_size, case names, shapes, MR-like)
CORPORA = {
    "acdc3d": ("acdc", "3d", [6, 16, 16],
               [f"patient{i:03d}" for i in range(1, 6)],
               [(5, 20, 22), (7, 18, 24), (6, 262, 19), (9, 21, 17),
                (4, 16, 16)], True),
    "acdc2d": ("acdc", "2d", [16, 16],
               [f"patient{i:03d}" for i in range(1, 5)],
               [(3, 20, 22), (4, 12, 14), (2, 17, 30), (3, 15, 16)], True),
    "lits": ("lits", "3d", [8, 16, 16], [3, 7, 11, 12, 20],
             [(6, 20, 22), (9, 14, 18), (10, 17, 17), (8, 16, 16),
              (12, 15, 25)], False),
    "kits": ("kits", "3d", [8, 16, 16], [0, 1, 2, 4, 9],
             [(6, 20, 22), (9, 14, 18), (10, 17, 17), (8, 16, 16),
              (12, 15, 25)], False),
    "bcv": ("bcv", "3d", [8, 16, 16], [1, 2, 3, 5, 8],
            [(6, 20, 22), (9, 14, 18), (10, 17, 17), (8, 16, 16),
             (12, 15, 25)], False),
    "amos_ct": ("amos_ct", "3d", [8, 16, 16], [5, 13, 70, 100, 292],
                [(6, 20, 22), (9, 14, 18), (10, 17, 17), (8, 16, 16),
                 (12, 15, 25)], False),
    "amos_mr": ("amos_mr", "3d", [8, 16, 16], [540, 553, 575, 580],
                [(6, 20, 22), (9, 14, 18), (10, 17, 17), (8, 16, 16)], True),
}


def _corpus(tmp_path, key):
    dataset, dim, ts, names, shapes, mr = CORPORA[key]
    root = tmp_path / key
    root.mkdir()
    rng = np.random.default_rng(len(key))
    classes = 3 if dataset == "kits" else 4
    for name, shape in zip(names, shapes):
        if dataset == "acdc":
            for frame in (0, 1):
                _write(root, f"{name}_{frame}", shape, rng, mr, classes)
        else:
            _write(root, str(name), shape, rng, mr, classes)
    _names(root, names)
    return dict(RECIPE_KEYS, dataset=dataset, model="medformer",
                dimension=dim, training_size=ts, data_root=str(root),
                classes=classes)


def _recipe_dict(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("key", sorted(CORPORA))
def test_dataset_reads_like_jax(key, tmp_path, monkeypatch):
    d = _corpus(tmp_path, key)
    if key.startswith("amos"):
        # a short fixed test split on both packages' classes (the real one
        # names 100 and 20 cases)
        test_split = CORPORA[key][3][1:3]
        for cls in (JD.AMOSCT, JD.AMOSMR, TD.AMOSCT, TD.AMOSMR):
            monkeypatch.setattr(cls, "TEST_SPLIT", test_split)
    jc, tc = jax_config(d), config_from_dict(d)
    for mode, fold in (("train", 0), ("test", 0), ("train", 2)):
        j = jax_get_dataset(jc, mode=mode, fold_idx=fold)
        t = get_dataset(tc, mode=mode, fold_idx=fold)
        assert type(t).__name__ == type(j).__name__
        assert t.name_list(tc, mode, 3, fold, 1) == \
            j.name_list(jc, mode, 3, fold, 1)
        assert len(t) == len(j) > 0
        for a, b in zip(t.images, j.images):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        for a, b in zip(t.labels, j.labels):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t.spacings, j.spacings):
            np.testing.assert_array_equal(a, b)
        if mode == "test":
            for i in range(len(t)):
                for a, b in zip(t.test_item(i), j.test_item(i)):
                    np.testing.assert_array_equal(a, b)
        assert _recipe_dict(t.recipe()) == _recipe_dict(j.recipe())


def test_acdc_3d_crops_y_to_256_and_pads_like_jax(tmp_path):
    """ACDC-3D's quirks on a written case: the +2 pad with floor halves on
    a short z and the centre 256 crop of a taller y."""
    cfg = config_from_dict(_corpus(tmp_path, "acdc3d"))
    shapes = {im.shape for mode in ("train", "test")
              for im in get_dataset(cfg, mode=mode).images}
    assert (6, 256, 19) in shapes          # (6, 262, 19): y cropped
    assert (7, 20, 22) in shapes           # (5, 20, 22): (6 + 2 - 5) // 2
    assert get_dataset(cfg).recipe().full_volume


def _train_step(tmp_path, cfg_dict, batch):
    cfg = config_from_dict(dict(cfg_dict, epochs=1, iter_per_epoch=1,
                                print_freq=1, val_freq=5, batch_size=batch,
                                cp_path=str(tmp_path / "exp"),
                                log_path=str(tmp_path / "log"),
                                unique_name="t"))
    train_net(cfg, 0, device="cpu")
    rows = [json.loads(ln) for ln in
            (tmp_path / "log" / cfg.dataset / "t" / "fold_0" /
             "scalars.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in rows if r["tag"] == "Train/StepLoss"]
    assert losses and np.isfinite(losses).all()


def test_kits_corpus_trains_a_step(tmp_path):
    """A narrow MedFormer-3D on a written KiTS corpus: the KiTS recipe's
    post ops and 60-voxel affine pad, from the device cache."""
    d = _corpus(tmp_path, "kits")
    cfg_dict = dict(TINY, **{k: v for k, v in d.items()
                             if k not in ("model",)})
    cfg_dict.update(training_size=[16, 16, 16], weight=[0.5, 1, 2],
                    aux_weight=[0.5, 0.5], optimizer="adamw", base_lr=4e-4,
                    ema=True)
    _train_step(tmp_path, cfg_dict, 2)


def test_acdc_2d_corpus_trains_a_step(tmp_path):
    """A narrow MedFormer-2D on a written ACDC corpus: its slices, its
    intensity pre ops before the affine."""
    d = _corpus(tmp_path, "acdc2d")
    cfg_dict = dict(TRAIN2D, **{k: v for k, v in d.items()
                                if k not in ("model", "scale", "rotate",
                                             "translate", "affine_pad_size")})
    cfg_dict.update(training_size=[16, 16], affine_pad_size=[4, 4],
                    device_cache="auto")
    _train_step(tmp_path, cfg_dict, 4)
