"""The training input pipeline (counterpart of ``cbim_tpu/data/pipeline.py``,
its host-window path).

    host:   pick volumes -> random (training_size + affine_pad) windows
            -> centred in a zero buffer -> one batch, copied to the device
    device: [pre-intensity ops] -> affine resample fused with the centre
            crop -> [post-intensity ops]

The window sampling makes the same ``np.random.default_rng(seed)`` calls as
the JAX package, so the host batches are identical.  The device part draws
from ``torch.Generator``s seeded from the same seed; its streams differ from
the JAX package's PRNG, so augmented batches match in distribution only.

Not ported (ROADMAP.md): the HBM-resident device cache, ``full_volume``
recipes, 2D, the native threaded batch assembler, and every op but
``gaussian_noise`` and ``brightness_multiply``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..ops import augment as A
from ..ops.resample import affine_sample_3d_batch


@dataclass(frozen=True)
class AugRecipe:
    """Declarative training-augmentation recipe, as the JAX package's.

    ops are (name, prob, params) triples; prob 1.0 means unconditional.
    pre_ops run on the precrop window before the affine, post_ops after the
    crop."""
    affine_prob: float = 1.0
    affine_pad: Sequence[int] = (0, 0, 0)
    scale: Sequence = (0.3, 0.3, 0.3)
    rotate: Sequence = (30, 30, 30)
    translate: Sequence = (0.0, 0.0, 0.0)
    shear: Sequence = (0.05, 0.05, 0.05)
    pre_ops: tuple = ()
    post_ops: tuple = ()
    full_volume: bool = False


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host draw to ``device`` without waiting for the queued work: a copy
    from pageable memory would synchronise the stream."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _apply_op(name: str, prob: float, params: dict, imgs: torch.Tensor,
              gen_host: torch.Generator, gen_dev: torch.Generator):
    """One op over the batch; samples whose U(0, 1) draw is >= prob keep
    their input."""
    B = imgs.shape[0]
    if name == "gaussian_noise" and "std" in params:
        out = A.gaussian_noise(imgs, gen_dev, params["std"])
    elif name == "brightness_multiply":
        lo, hi = params["range"]
        factor = _to_device(A.draw_uniform(gen_host, B, lo, hi), imgs.device)
        out = A.brightness_multiply(imgs, factor)
    else:
        raise NotImplementedError(
            f"augmentation op {name!r} is not ported yet (see ROADMAP.md)")
    if prob >= 1.0:
        return out
    take = _to_device(torch.rand(B, generator=gen_host) < prob, imgs.device)
    return torch.where(take.view(-1, *[1] * (imgs.dim() - 1)), out, imgs)


def build_batch_aug(recipe: AugRecipe, crop_size):
    """Batched 3D augmentation ``fn(imgs, labs, gen_host, gen_dev) ->
    (imgs, labs)``: imgs (B, *buffer, C) float, labs (B, *buffer) int on the
    device -> (B, *crop_size, C), (B, *crop_size)."""
    if recipe.full_volume:
        raise NotImplementedError("full_volume recipes are not ported yet "
                                  "(see ROADMAP.md)")
    crop_size = tuple(int(t) for t in crop_size)
    for name, _, params in recipe.pre_ops + recipe.post_ops:
        if name not in ("gaussian_noise", "brightness_multiply") \
                or "std_range" in params:
            raise NotImplementedError(
                f"augmentation op {name!r} {params} is not ported yet "
                f"(see ROADMAP.md)")

    def fn(imgs, labs, gen_host, gen_dev):
        B = imgs.shape[0]
        for name, prob, params in recipe.pre_ops:
            imgs = _apply_op(name, prob, params, imgs, gen_host, gen_dev)
        thetas = A.random_theta_3d(gen_host, B, recipe.scale, recipe.rotate,
                                   recipe.translate, recipe.shear)
        if recipe.affine_prob < 1.0:
            take = torch.rand(B, generator=gen_host) < recipe.affine_prob
            eye = torch.eye(3, 4).expand(B, 3, 4)
            thetas = torch.where(take.view(B, 1, 1), thetas, eye)
        imgs, labs = affine_sample_3d_batch(
            imgs, labs, _to_device(thetas, imgs.device), out_shape=crop_size)
        for name, prob, params in recipe.post_ops:
            imgs = _apply_op(name, prob, params, imgs, gen_host, gen_dev)
        return imgs, labs

    return fn


class TrainPipeline:
    """Host window sampler + batched device augmentation.

    ``next_batch`` copies the batch's precrop windows into pinned host
    memory (on CUDA), moves them with a non-blocking copy and augments them
    on the device.  Called after the previous step is queued, the host work
    overlaps that step."""

    def __init__(self, dataset, cfg, seed: int = 0, device=None):
        if cfg.dimension != "3d":
            raise NotImplementedError("2D training is not ported yet "
                                      "(see ROADMAP.md)")
        self.ds = dataset
        self.crop_size = tuple(cfg.training_size[:3])
        self.recipe = dataset.recipe()
        self.buffer_shape = tuple(
            t + p for t, p in zip(self.crop_size, self.recipe.affine_pad))
        self.device = torch.device(device or "cpu")
        self._rng = np.random.default_rng(seed)
        self._gen_host = torch.Generator().manual_seed(seed)
        self._gen_dev = torch.Generator(device=self.device).manual_seed(seed)
        self._aug = build_batch_aug(self.recipe, self.crop_size)

    # -- host side (the JAX package's rng calls, in its order) --------------

    def _virtual_start(self, s: int, ax: int) -> int:
        """Window start relative to the volume (may be negative: zero
        margin); crop centres fall uniformly in [crop/2, s - crop/2]."""
        b = self.buffer_shape[ax]
        if s <= b:
            return -((b - s) // 2)
        m = (b - self.crop_size[ax]) // 2
        return int(self._rng.integers(-m, s - b + m + 1))

    def _window_coords(self, shape):
        """Per axis: source start, copy width, offset in the buffer."""
        starts, sizes, offs = [], [], []
        for ax, b in enumerate(self.buffer_shape):
            s = shape[ax]
            v = self._virtual_start(s, ax)
            src0, src1 = max(v, 0), min(v + b, s)
            starts.append(src0)
            sizes.append(src1 - src0)
            offs.append(src0 - v)
        return starts, sizes, offs

    def _host_tensors(self, batch_size: int):
        """(imgs (B, *buffer, 1) float32, labs (B, *buffer) int8) as CPU
        tensors, pinned when the pipeline feeds a CUDA device."""
        pin = self.device.type == "cuda"
        imgs = torch.zeros((batch_size, *self.buffer_shape, 1),
                           dtype=torch.float32, pin_memory=pin)
        labs = torch.zeros((batch_size, *self.buffer_shape), dtype=torch.int8,
                           pin_memory=pin)
        np_imgs, np_labs = imgs.numpy(), labs.numpy()
        idxs = self._rng.integers(0, len(self.ds.images), size=batch_size)
        for i, idx in enumerate(idxs):
            img, lab = self.ds.images[idx], self.ds.labels[idx]
            starts, sizes, offs = self._window_coords(img.shape)
            src = tuple(slice(s0, s0 + w) for s0, w in zip(starts, sizes))
            dst = tuple(slice(o, o + w) for o, w in zip(offs, sizes))
            np_imgs[(i, *dst, 0)] = img[src]
            np_labs[(i, *dst)] = lab[src]
        return imgs, labs

    def host_batch(self, batch_size: int):
        """The precrop windows as numpy arrays: images (B, *buffer, 1)
        float32, labels (B, *buffer) int8."""
        imgs, labs = self._host_tensors(batch_size)
        return imgs.numpy(), labs.numpy()

    # -- device side ----------------------------------------------------------

    def next_batch(self, batch_size: int):
        """(img (B, *crop, 1) float32, lab (B, *crop) int64) on the device."""
        imgs, labs = self._host_tensors(batch_size)
        imgs = imgs.to(self.device, non_blocking=True)
        labs = labs.to(self.device, non_blocking=True).long()
        return self._aug(imgs, labs, self._gen_host, self._gen_dev)
