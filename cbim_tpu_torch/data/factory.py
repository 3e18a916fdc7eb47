"""Dataset factory (counterpart of ``cbim_tpu/data/factory.py``; reference
training/dataset/utils.py:3 get_dataset)."""

from __future__ import annotations


def get_dataset(cfg, mode: str = "train", fold_idx: int = 0):
    from . import datasets as D
    registry_3d = {
        "acdc": D.ACDC3D,
        "lits": D.LiTS,
        "kits": D.KiTS,
        "bcv": D.BCV,
        "amos_ct": D.AMOSCT,
        "amos_mr": D.AMOSMR,
        "synthetic": D.Synthetic3D,
    }
    registry_2d = {
        "acdc": D.ACDC2D,
        "synthetic": D.Synthetic2D,
    }
    dim, name = cfg.dimension, cfg.dataset
    registry = registry_2d if dim == "2d" else registry_3d
    if name not in registry:
        raise ValueError(f"unknown dataset {name!r} for dimension {dim!r}")
    return registry[name](cfg, mode=mode, k_fold=cfg.k_fold, k=fold_idx,
                          seed=cfg.split_seed)
