"""Offline dataset conversion (counterpart of
``cbim_tpu/data/conversion/convert.py``; reference
dataset_conversion/*_3d.py).

Converts raw downloads into the on-disk layout the datasets read:
``{name}.nii.gz`` / ``{name}_gt.nii.gz`` and ``list/dataset.yaml``.

The reference's two-stage resampling: x/y to the target spacing by cubic
spline, then z by *nearest* (sic — acdc_3d.py:28, lits_3d.py:35), labels
nearest throughout, then (CT datasets) a crop to the foreground with a
context margin.  Target spacings and crops are the reference's hard-coded
values (``SPECS``).  Volumes are written with the port's ``write_nifti``
(gzip level 1).

Run:  python -m cbim_tpu_torch.data.conversion.convert <dataset> <src> <dst>

<dataset> is acdc, acdc_2d, lits, kits, bcv, amos_ct or amos_mr.  ACDC's
<src> holds one folder a patient (``patientXXX_frameYY.nii.gz`` with its
``_gt``); LiTS, KiTS and BCV's holds ``images/`` and ``labels/`` (same file
names, the case number the digits of the name); AMOS's holds ``imagesTr/``
and ``labelsTr/`` (``amos_XXXX.nii.gz``: CT below 500, MR from 500).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..nifti import read_nifti, write_nifti
from .utils import CropForeground, resample_label_to_shape, resample_to_spacing

#: target spacing (x, y, z) and crop context (z, y, x) or None
SPECS = {
    "acdc": dict(spacing=(1.5625, 1.5625, 5.0), crop=None),
    "lits": dict(spacing=(0.767578125, 0.767578125, 1.0), crop=(10, 30, 30)),
    "kits": dict(spacing=(0.781625, 0.781625, 0.781625), crop=(30, 30, 30)),
    "bcv": dict(spacing=(0.75, 0.75, 3.0), crop=(5, 20, 20)),
    "amos_ct": dict(spacing=(0.68825, 0.68825, 2.0), crop=(30, 30, 30)),
    "amos_mr": dict(spacing=(1.1875, 1.1875, 2.0), crop=(30, 30, 30)),
}


def convert_case(img: np.ndarray, lab: np.ndarray, spacing_zyx,
                 target_spacing_xyz, crop_context=None):
    """Two-stage resample and the optional foreground crop of one case;
    returns (img, lab)."""
    tx, ty, tz = target_spacing_xyz
    sz, sy, sx = spacing_zyx
    # stage 1: x/y by cubic spline, z unchanged
    img = resample_to_spacing(img, (sz, sy, sx), (sz, ty, tx), order=3)
    lab = resample_label_to_shape(lab, img.shape)
    # stage 2: z by nearest (the reference's quirk)
    img = resample_to_spacing(img, (sz, ty, tx), (tz, ty, tx), order=0)
    lab = resample_label_to_shape(lab, img.shape)
    if crop_context is not None:
        img, lab = CropForeground(img, lab, crop_context)
    return img, lab


def _write_case(dst: str, stem: str, img, lab, target_xyz) -> None:
    spacing = (target_xyz[2], target_xyz[1], target_xyz[0])
    write_nifti(os.path.join(dst, f"{stem}.nii.gz"), img, spacing)
    write_nifti(os.path.join(dst, f"{stem}_gt.nii.gz"), lab.astype(np.uint8),
                spacing)


def write_name_list(dst: str, names: list) -> None:
    """``list/dataset.yaml``: the case names, as the datasets read them."""
    import yaml
    os.makedirs(os.path.join(dst, "list"), exist_ok=True)
    with open(os.path.join(dst, "list", "dataset.yaml"), "w") as f:
        yaml.dump(names, f)


def _convert_file(img_path: str, lab_path: str, dataset: str):
    spec = SPECS[dataset]
    img = read_nifti(img_path)
    lab = read_nifti(lab_path)
    return convert_case(img.data.astype(np.float32),
                        lab.data.astype(np.uint8), img.spacing,
                        spec["spacing"], spec["crop"])


def convert_acdc(src: str, dst: str, two_d: bool = False):
    """acdc_3d.py / acdc_2d.py: each patient's labelled frames (ED, ES) as
    ``patientXXX_{0,1}``; 2D keeps each volume's z spacing."""
    spec = SPECS["acdc"]
    os.makedirs(dst, exist_ok=True)
    names = []
    for patient in sorted(os.listdir(src)):
        pdir = os.path.join(src, patient)
        if not os.path.isdir(pdir):
            continue
        count = 0
        for f in sorted(os.listdir(pdir)):
            if "_gt" not in f or not f.endswith(".nii.gz"):
                continue
            frame = f.replace("_gt.nii.gz", "")
            img = read_nifti(os.path.join(pdir, frame + ".nii.gz"))
            lab = read_nifti(os.path.join(pdir, f))
            target = spec["spacing"]
            if two_d:
                target = (target[0], target[1], img.spacing[0])
            ci, cl = convert_case(img.data.astype(np.float32),
                                  lab.data.astype(np.uint8), img.spacing,
                                  target, spec["crop"])
            _write_case(dst, f"{patient}_{count}", ci, cl, target)
            count += 1
        if count:
            names.append(patient)
            print(patient, "done")
    write_name_list(dst, names)


def convert_ct(dataset: str, src_img: str, src_lab: str, dst: str,
               name_fn=None):
    """lits/kits/bcv-style: cases named by integers (``name_fn`` of the
    file name, else the file's index)."""
    os.makedirs(dst, exist_ok=True)
    names = []
    files = sorted(f for f in os.listdir(src_img) if f.endswith(".nii.gz"))
    for i, f in enumerate(files):
        name = name_fn(f) if name_fn else i
        ci, cl = _convert_file(os.path.join(src_img, f),
                               os.path.join(src_lab, f), dataset)
        _write_case(dst, str(name), ci, cl, SPECS[dataset]["spacing"])
        names.append(int(name))
        print(name, "done")
    write_name_list(dst, names)


def convert_amos(dataset: str, src: str, dst: str):
    """amos_3d.py: ``imagesTr``/``labelsTr``, CT ids below 500, MR from
    500."""
    want_ct = dataset == "amos_ct"
    img_dir = os.path.join(src, "imagesTr")
    lab_dir = os.path.join(src, "labelsTr")
    os.makedirs(dst, exist_ok=True)
    names = []
    for f in sorted(os.listdir(img_dir)):
        if not f.endswith(".nii.gz"):
            continue
        idx = int(f.split(".")[0].split("_")[1])
        if (idx < 500) != want_ct:
            continue
        ci, cl = _convert_file(os.path.join(img_dir, f),
                               os.path.join(lab_dir, f), dataset)
        _write_case(dst, str(idx), ci, cl, SPECS[dataset]["spacing"])
        names.append(idx)
        print(idx, "done")
    write_name_list(dst, names)


def case_number(filename: str) -> int:
    """The case number of a LiTS/KiTS/BCV file: the digits of its stem."""
    return int("".join(c for c in filename.split(".")[0] if c.isdigit()))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 3:
        print(__doc__)
        raise SystemExit(1)
    dataset, src, dst = argv[0], argv[1], argv[2]
    if dataset in ("acdc", "acdc_2d"):
        convert_acdc(src, dst, two_d=dataset.endswith("2d"))
    elif dataset in ("lits", "kits", "bcv"):
        convert_ct(dataset, os.path.join(src, "images"),
                   os.path.join(src, "labels"), dst, name_fn=case_number)
    elif dataset in ("amos_ct", "amos_mr"):
        convert_amos(dataset, src, dst)
    else:
        raise SystemExit(f"unknown dataset {dataset}")


if __name__ == "__main__":
    main()
