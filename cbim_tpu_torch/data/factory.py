"""Dataset factory (counterpart of ``cbim_tpu/data/factory.py``)."""

from __future__ import annotations


def get_dataset(cfg, mode: str = "train", fold_idx: int = 0):
    from . import datasets as D
    registry = {("3d", "synthetic"): D.Synthetic3D,
                ("2d", "synthetic"): D.Synthetic2D}
    cls = registry.get((cfg.dimension, cfg.dataset))
    if cls is None:
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} ({cfg.dimension}) is not ported yet; the "
            f"PyTorch port trains on 'synthetic' 3D and 2D (see ROADMAP.md)")
    return cls(cfg, mode=mode, k_fold=cfg.k_fold, k=fold_idx,
               seed=cfg.split_seed)
