"""Dataset factory (counterpart of ``cbim_tpu/data/factory.py``)."""

from __future__ import annotations


def get_dataset(cfg, mode: str = "train", fold_idx: int = 0):
    if cfg.dimension == "3d" and cfg.dataset == "synthetic":
        from .datasets import Synthetic3D
        return Synthetic3D(cfg, mode=mode, k_fold=cfg.k_fold, k=fold_idx,
                           seed=cfg.split_seed)
    raise NotImplementedError(
        f"dataset {cfg.dataset!r} ({cfg.dimension}) is not ported yet; the "
        f"PyTorch port trains on 'synthetic' 3D (see ROADMAP.md)")
