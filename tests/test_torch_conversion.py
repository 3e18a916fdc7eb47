"""The port's offline conversion against ``cbim_tpu.data.conversion``, on
the CPU: ``convert_case``, ``CropForeground``, ``reorient_to_ras`` and the
CLI (``python -m cbim_tpu_torch.data.conversion.convert``) on raw cases
written by the test give the JAX package's arrays, spacings and name
lists."""

import sys

import numpy as np
import pytest
import yaml

from cbim_tpu.data.conversion import convert as jax_convert
from cbim_tpu.data.conversion import utils as jax_utils
from cbim_tpu_torch.data.conversion import (CropForeground, convert,
                                            reorient_to_ras)
from cbim_tpu_torch.data.nifti import read_nifti, write_nifti
from test_torch_threads import few_torch_threads  # noqa: F401


def _case(seed, shape=(7, 30, 26), classes=3):
    rng = np.random.default_rng(seed)
    img = rng.normal(40, 300, size=shape).astype(np.float32)
    lab = np.zeros(shape, np.uint8)
    lab[2:5, 8:20, 6:15] = rng.integers(1, classes, size=(3, 12, 9))
    return img, lab


@pytest.mark.parametrize("dataset", ["acdc", "kits", "bcv"])
def test_convert_case_matches_jax(dataset):
    img, lab = _case(1)
    spec = convert.SPECS[dataset]
    assert spec == jax_convert.SPECS[dataset]
    spacing = (3.3, 1.1, 0.9)
    ti, tl = convert.convert_case(img, lab, spacing, spec["spacing"],
                                  spec["crop"])
    ji, jl = jax_convert.convert_case(img, lab, spacing, spec["spacing"],
                                      spec["crop"])
    assert ti.shape == ji.shape and ti.dtype == ji.dtype
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("context", [(10, 30, 30), (1, 2, 3), (0, 0, 0)])
def test_crop_foreground_matches_jax(context):
    img, lab = _case(2)
    ti, tl = CropForeground(img, lab, context)
    ji, jl = jax_utils.CropForeground(img, lab, context)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    empty = np.zeros_like(lab)
    ti, tl = CropForeground(img, empty, context)
    assert ti is img and tl is empty          # no foreground: unchanged


def _affines():
    """Permuted and flipped voxel-to-world rotations, and a degenerate one
    (two world axes on one voxel axis)."""
    out = []
    for perm in ((0, 1, 2), (2, 0, 1), (1, 2, 0)):
        for signs in ((1, 1, 1), (-1, 1, -1), (1, -1, 1)):
            a = np.eye(4)
            a[:3, :3] = np.eye(3)[list(perm)] * np.array(signs)[:, None] \
                * np.array([0.8, 1.2, 2.5])[:, None]
            a[:3, 3] = [10.0, -4.0, 7.0]
            out.append(a)
    deg = np.eye(4)
    deg[:3, :3] = [[1.0, 0.0, 0.0], [0.9, 0.1, 0.0], [0.0, 0.0, 1.0]]
    out.append(deg)
    return out


@pytest.mark.parametrize("i", range(10))
def test_reorient_to_ras_matches_jax(i):
    affine = _affines()[i]
    data = np.random.default_rng(i).normal(size=(5, 6, 7)).astype(np.float32)
    td, ta = reorient_to_ras(data, affine)
    jd, ja = jax_utils.reorient_to_ras(data, affine)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ta, ja)


def _run_jax_cli(monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", ["convert.py", *args])
    jax_convert.main()


def _same_tree(a, b, names):
    with open(a / "list" / "dataset.yaml") as f:
        ta = yaml.safe_load(f)
    with open(b / "list" / "dataset.yaml") as f:
        tb = yaml.safe_load(f)
    assert ta == tb == names
    files = sorted(p.name for p in a.glob("*.nii.gz"))
    assert files == sorted(p.name for p in b.glob("*.nii.gz")) and files
    for name in files:
        x, y = read_nifti(a / name), read_nifti(b / name)
        assert x.data.dtype == y.data.dtype
        np.testing.assert_array_equal(x.data, y.data)
        assert x.spacing == y.spacing


def test_cli_converts_a_ct_corpus_like_jax(tmp_path, monkeypatch):
    src = tmp_path / "raw"
    (src / "images").mkdir(parents=True)
    (src / "labels").mkdir()
    for n, seed in ((3, 0), (12, 1)):
        img, lab = _case(seed)
        write_nifti(src / "images" / f"case_{n:05d}.nii.gz",
                    img.astype(np.int16), (1.7, 0.9, 0.9))
        write_nifti(src / "labels" / f"case_{n:05d}.nii.gz", lab,
                    (1.7, 0.9, 0.9))
    convert.main(["kits", str(src), str(tmp_path / "port")])
    _run_jax_cli(monkeypatch, "kits", str(src), str(tmp_path / "jax"))
    _same_tree(tmp_path / "port", tmp_path / "jax", [3, 12])


@pytest.mark.parametrize("dataset", ["acdc", "acdc_2d"])
def test_cli_converts_acdc_like_jax(dataset, tmp_path, monkeypatch):
    src = tmp_path / "raw"
    for p, seed in (("patient001", 3), ("patient002", 4)):
        (src / p).mkdir(parents=True)
        for frame in (1, 12):
            img, lab = _case(seed + frame, shape=(6, 24, 20), classes=4)
            stem = src / p / f"{p}_frame{frame:02d}"
            write_nifti(f"{stem}.nii.gz", np.abs(img), (10.0, 1.4, 1.4))
            write_nifti(f"{stem}_gt.nii.gz", lab, (10.0, 1.4, 1.4))
    convert.main([dataset, str(src), str(tmp_path / "port")])
    _run_jax_cli(monkeypatch, dataset, str(src), str(tmp_path / "jax"))
    _same_tree(tmp_path / "port", tmp_path / "jax",
               ["patient001", "patient002"])


def test_cli_converts_amos_by_modality_like_jax(tmp_path, monkeypatch):
    src = tmp_path / "raw"
    (src / "imagesTr").mkdir(parents=True)
    (src / "labelsTr").mkdir()
    for n, seed in ((5, 0), (540, 1)):          # one CT id, one MR id
        img, lab = _case(seed)
        write_nifti(src / "imagesTr" / f"amos_{n:04d}.nii.gz", img,
                    (2.5, 0.8, 0.8))
        write_nifti(src / "labelsTr" / f"amos_{n:04d}.nii.gz", lab,
                    (2.5, 0.8, 0.8))
    for dataset, names in (("amos_ct", [5]), ("amos_mr", [540])):
        convert.main([dataset, str(src), str(tmp_path / f"port_{dataset}")])
        _run_jax_cli(monkeypatch, dataset, str(src),
                     str(tmp_path / f"jax_{dataset}"))
        _same_tree(tmp_path / f"port_{dataset}", tmp_path / f"jax_{dataset}",
                   names)
    with pytest.raises(SystemExit):
        convert.main(["brats", str(src), str(tmp_path / "x")])
