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

2D (slice) training draws its samples from a per-epoch permutation without
replacement, as the JAX package does (reference DataLoader semantics); a
batch that reaches the end of one permutation is filled from the next, so
the n % batch tail of an epoch's slices opens the next epoch's first batch
(ROADMAP C3).  3D draws i.i.d.

Not ported (ROADMAP.md): the HBM-resident device cache, ``full_volume``
recipes, the native threaded batch assembler, and every op but
``gaussian_noise`` and ``brightness_multiply``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..ops import augment as A
from ..ops._backend import get_device
from ..ops.resample import affine_sample_2d_batch, affine_sample_3d_batch


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
    """Batched augmentation ``fn(imgs, labs, gen_host, gen_dev) ->
    (imgs, labs)``: imgs (B, *buffer, C) float, labs (B, *buffer) int on the
    device -> (B, *crop_size, C), (B, *crop_size); 3D or 2D by the length
    of ``crop_size``.  The 2D affine is ``random_theta_2d`` (no shear
    ranges of its own: the 2D reference draws shears from the scales)."""
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

    nd = len(crop_size)
    if nd == 3:
        def draw_thetas(gen_host, B):
            return A.random_theta_3d(gen_host, B, recipe.scale, recipe.rotate,
                                     recipe.translate, recipe.shear)
        sample = affine_sample_3d_batch
    else:
        def draw_thetas(gen_host, B):
            return A.random_theta_2d(gen_host, B, recipe.scale, recipe.rotate,
                                     recipe.translate)
        sample = affine_sample_2d_batch

    def fn(imgs, labs, gen_host, gen_dev):
        B = imgs.shape[0]
        for name, prob, params in recipe.pre_ops:
            imgs = _apply_op(name, prob, params, imgs, gen_host, gen_dev)
        thetas = draw_thetas(gen_host, B)
        if recipe.affine_prob < 1.0:
            take = torch.rand(B, generator=gen_host) < recipe.affine_prob
            eye = torch.eye(nd, nd + 1).expand(B, nd, nd + 1)
            thetas = torch.where(take.view(B, 1, 1), thetas, eye)
        imgs, labs = sample(imgs, labs, _to_device(thetas, imgs.device),
                            out_shape=crop_size)
        for name, prob, params in recipe.post_ops:
            imgs = _apply_op(name, prob, params, imgs, gen_host, gen_dev)
        return imgs, labs

    return fn


class TrainPipeline:
    """Host window sampler + batched device augmentation, 3D or 2D.

    ``next_batch`` copies the batch's precrop windows into pinned host
    memory (on CUDA), moves them with a non-blocking copy and augments them
    on the device.  Called after the previous step is queued, the host work
    overlaps that step.  ``device``: the card unless the caller asks for the
    CPU."""

    def __init__(self, dataset, cfg, seed: int = 0, device="cuda"):
        self.ds = dataset
        self.ndim = 3 if cfg.dimension == "3d" else 2
        self.crop_size = tuple(cfg.training_size[:self.ndim])
        self.recipe = dataset.recipe()
        self.buffer_shape = tuple(
            t + p for t, p in zip(self.crop_size, self.recipe.affine_pad))
        self.device = get_device(device)
        self._rng = np.random.default_rng(seed)
        self._gen_host = torch.Generator().manual_seed(seed)
        self._gen_dev = torch.Generator(device=self.device).manual_seed(seed)
        self._aug = build_batch_aug(self.recipe, self.crop_size)
        self._epoch_perm = None
        self._perm_pos = 0

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

    def _draw_indices(self, batch_size: int) -> np.ndarray:
        """Sample indices: i.i.d. uniform (3D), or the next ``batch_size`` of
        a per-epoch permutation without replacement (2D), drawing a new
        permutation whenever one runs out, mid-batch included."""
        n = len(self.ds.images)
        if self.ndim == 3:
            return self._rng.integers(0, n, size=batch_size)
        out = np.empty(batch_size, np.int64)
        filled = 0
        while filled < batch_size:
            if self._epoch_perm is None or self._perm_pos >= n:
                self._epoch_perm = self._rng.permutation(n)
                self._perm_pos = 0
            take = min(batch_size - filled, n - self._perm_pos)
            out[filled:filled + take] = \
                self._epoch_perm[self._perm_pos:self._perm_pos + take]
            filled += take
            self._perm_pos += take
        return out

    def _host_tensors(self, batch_size: int):
        """(imgs (B, *buffer, 1) float32, labs (B, *buffer) int8) as CPU
        tensors, pinned when the pipeline feeds a CUDA device."""
        pin = self.device.type == "cuda"
        imgs = torch.zeros((batch_size, *self.buffer_shape, 1),
                           dtype=torch.float32, pin_memory=pin)
        labs = torch.zeros((batch_size, *self.buffer_shape), dtype=torch.int8,
                           pin_memory=pin)
        np_imgs, np_labs = imgs.numpy(), labs.numpy()
        idxs = self._draw_indices(batch_size)
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
