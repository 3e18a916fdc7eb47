"""The training input pipeline (counterpart of ``cbim_tpu/data/pipeline.py``).

Two ways to the device, chosen as the JAX package chooses them
(``device_cache``: ``auto``, true or false; ``device_cache_bytes``, 4 GB):

- the device cache (``auto`` when the padded corpus fits the byte limit):
  every volume (3D) or slice (2D) is parked once on the device, zero-padded
  to one shape with margins on every side a window can reach, in
  ``cache_dtype`` (bfloat16 unless the config says float32); each step
  sends only the window starts, and the windows are sliced on the device;
- the host windows (otherwise): each step copies the batch's precrop
  windows into pinned host memory and moves them with a non-blocking copy.
  In 3D the native batch assembler (``data/native.py``, as the JAX package
  uses ``native/cbim_host.cpp``) writes them straight into the pinned
  tensors on a pool of threads; ``native = False`` on a pipeline takes the
  numpy copy instead, which gives the same bytes.

Then, on the device:

    [pre-intensity ops] -> affine resample fused with the centre crop
        -> [post-intensity / mirror ops]

``full_volume`` recipes (ACDC-3D's) on the device cache follow the
reference exactly: the pre-ops run on each sample's full cache row in fp32,
their statistics over the true volume (a mask), the row re-zeroed outside
it; the affine grid spans the whole true volume and the random crop
(start ``randint(0, max(S - ts, 1))``, volume coordinates) is fused into
the resample (``affine_sample_3d_fullvol_batch``).  On the host-window
path a ``full_volume`` recipe runs on the (training_size + pad) precrop
instead, the JAX package's documented approximation.  The config key
``full_volume`` overrides the recipe's choice, as in JAX.

The window sampling makes the same ``np.random.default_rng(seed)`` calls as
the JAX package, in its order, so the host batches, the cache and the
window starts are identical.  The augmentation draws from
``torch.Generator``s seeded from the same seed (per-sample scalars on the
CPU, per-voxel noise on the device); its streams differ from the JAX
package's PRNG, so augmented batches match in distribution only (ROADMAP
C5).

2D (slice) training draws its samples from a per-epoch permutation without
replacement, as the JAX package does (reference DataLoader semantics); a
batch that reaches the end of one permutation is filled from the next, so
the n % batch tail of an epoch's slices opens the next epoch's first batch
(ROADMAP C3).  3D draws i.i.d.

Under data parallelism (``mesh``) every rank makes the global batch's
host-side draws with the shared seed (the sample indices, the 2D epoch
permutations, the window starts, the gates, the affines and every drawn
scalar), keeps its own rows (``parallel.batch_rows``) and augments only
those, so the ranks' batches, concatenated, are the one-process batch.
What is drawn on the device (the per-voxel noise) comes from a generator
seeded seed + data index (the rank, without a 'spatial' axis).  Each rank's
device cache holds the whole corpus, as the JAX package replicates it over
the mesh.

Under a 'spatial' mesh axis the s peers of a data index make the same
draws, the device noise included (its generator is seeded by the data
index), augment the same rows whole and keep their H slab of the result
(``parallel.spatial.slab``): the peers' slabs, joined along H, are that
data index's batch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np
import torch

from ..ops import augment as A
from ..ops._backend import get_device
from ..parallel.mesh import batch_rows
from ..parallel.spatial import slab
from ..ops.resample import (affine_sample_2d_batch, affine_sample_3d_batch,
                            affine_sample_3d_fullvol_batch)


@dataclass(frozen=True)
class AugRecipe:
    """Declarative training-augmentation recipe, as the JAX package's.

    ops are (name, prob, params) triples; prob 1.0 means unconditional.
    pre_ops run before the affine (ACDC style, dataset_acdc.py:141-149): on
    the full volume when ``full_volume`` is set and the device cache is
    active, else on the precrop window; post_ops run after the crop (AMOS
    style, dataset_amos_ct.py:141-153).  ``num_classes`` (the config's
    ``classes`` unless the recipe sets it) bounds the label ids: the JAX
    package's TPU gather carries labels in the image dtype, the port's
    cache and host windows in int8, so ``TrainPipeline`` refuses a recipe
    whose ids would not fit."""
    affine_prob: float = 1.0
    affine_pad: Sequence[int] = (0, 0, 0)
    scale: Sequence = (0.3, 0.3, 0.3)
    rotate: Sequence = (30, 30, 30)
    translate: Sequence = (0.0, 0.0, 0.0)
    shear: Sequence = (0.05, 0.05, 0.05)
    pre_ops: tuple = ()
    post_ops: tuple = ()
    full_volume: bool = False
    num_classes: int | None = None


#: pre_ops that stay exact on a zero-padded full-volume cache row: pointwise
#: ops whose padding residue the re-zero removes, and gamma, which takes the
#: mask for its statistics.  Ops with neighbourhood or unmasked-statistic
#: semantics (blur, contrast, ...) would diverge, so a full_volume recipe is
#: restricted to these (``cbim_tpu/data/pipeline.py:74-80``).
_FULLVOL_SAFE_PRE = {"gaussian_noise", "brightness_additive", "gamma"}

#: the cache's dtype names (the config's ``cache_dtype``)
_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host draw to ``device`` without waiting for the queued work: a copy
    from pageable memory would synchronise the stream."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclass(frozen=True)
class Rows:
    """A rank's rows [start, stop) of a global batch of ``total``."""
    start: int
    stop: int
    total: int


def _whole(rows: Rows | None, n: int) -> tuple[slice, int]:
    """(the rows of the draws a batch of ``n`` keeps, how many to draw):
    all n without ``rows``; with them every row of the global batch is
    drawn and the rank's kept, so that its draws are the one-process
    batch's rows."""
    if rows is None:
        return slice(0, n), n
    return slice(rows.start, rows.stop), rows.total


def _apply_op(name: str, params: dict, imgs: torch.Tensor, labs: torch.Tensor,
              gen_host: torch.Generator, gen_dev: torch.Generator,
              mask=None, count=None, rows: Rows | None = None):
    """One op over the batch, every sample's scalars drawn from
    ``gen_host`` (per-voxel noise from ``gen_dev``); returns (imgs, labs).
    ``mask``/``count`` (the full-volume path) restrict gamma's statistics to
    the true volume.  ``rows``: the batch is these rows of a global batch
    (``Rows``), whose scalars are all drawn."""
    dev = imgs.device
    keep, G = _whole(rows, imgs.shape[0])

    def draw(lo, hi):
        return _to_device(A.draw_uniform(gen_host, G, lo, hi)[keep], dev)

    if name == "gaussian_noise":
        if "std_range" in params:
            std = draw(*params["std_range"])
            noise = torch.randn(imgs.shape, generator=gen_dev, device=dev,
                                dtype=imgs.dtype)
            return A.add_noise(imgs, noise, std), labs
        return A.gaussian_noise(imgs, gen_dev, params["std"]), labs
    if name == "brightness_additive":
        shift = torch.randn(G, generator=gen_host)[keep] * params["std"]
        return A.brightness_additive(imgs, _to_device(shift, dev)), labs
    if name == "brightness_multiply":
        return A.brightness_multiply(imgs, draw(*params["range"])), labs
    if name == "gamma":
        return A.gamma(imgs, draw(*params["range"]),
                       params.get("retain_stats", True), mask=mask,
                       count=count), labs
    if name == "contrast":
        return A.contrast(imgs, draw(*params["range"])), labs
    if name == "gaussian_blur":
        lo, hi = params["range"]
        return A.gaussian_blur(imgs, draw(lo, hi), hi), labs
    if name == "mirror":
        return A.mirror(imgs, labs, params["axis"])
    if name == "elastic":
        # opt-in extra (no reference counterpart: augmentation.py is
        # affine-only); see ops/augment.py elastic_deform
        nd = labs.dim() - 1
        grid = tuple(params.get("grid", (4,) * nd))
        magnitude = tuple(params.get("magnitude", (0.05,) * nd))
        disp = torch.rand((G, nd, *grid), generator=gen_host)[keep] * 2.0 \
            - 1.0
        return A.elastic_deform(imgs, labs, _to_device(disp, dev), magnitude)
    raise ValueError(f"unknown aug op {name!r}")


def _draw_gate(gen_host: torch.Generator, n: int, prob: float) -> torch.Tensor:
    """n per-sample Bernoulli(prob) draws (bool, CPU)."""
    return torch.rand(n, generator=gen_host) < prob


def _gated(name, prob, params, imgs, labs, gen_host, gen_dev, mask=None,
           count=None, rows=None):
    """``_apply_op`` behind a per-sample Bernoulli(prob) gate, drawn first:
    samples whose gate is off keep their input, their label too; the label
    changes only where the op changes it (mirror, elastic)."""
    if prob >= 1.0:
        return _apply_op(name, params, imgs, labs, gen_host, gen_dev, mask,
                         count, rows)
    keep, G = _whole(rows, imgs.shape[0])
    take = _draw_gate(gen_host, G, prob)[keep]
    out_img, out_lab = _apply_op(name, params, imgs, labs, gen_host, gen_dev,
                                 mask, count, rows)
    take = _to_device(take, imgs.device)
    img = torch.where(take.view(-1, *[1] * (imgs.dim() - 1)), out_img, imgs)
    if out_lab is labs:
        return img, labs
    return img, torch.where(take.view(-1, *[1] * (labs.dim() - 1)), out_lab,
                            labs)


def _draw_thetas(recipe: AugRecipe, nd: int, gen_host, B: int,
                 rows: Rows | None = None) -> torch.Tensor:
    """The batch's affines, identity for the samples whose Bernoulli
    (affine_prob) branch draw is off (the reference's crop trick); with
    ``rows``, those rows of the global batch's."""
    keep, B = _whole(rows, B)
    if nd == 3:
        thetas = A.random_theta_3d(gen_host, B, recipe.scale, recipe.rotate,
                                   recipe.translate, recipe.shear)
    else:
        thetas = A.random_theta_2d(gen_host, B, recipe.scale, recipe.rotate,
                                   recipe.translate)
    if recipe.affine_prob < 1.0:
        take = _draw_gate(gen_host, B, recipe.affine_prob)
        eye = torch.eye(nd, nd + 1).expand(B, nd, nd + 1)
        thetas = torch.where(take.view(B, 1, 1), thetas, eye)
    return thetas[keep]


def _run_ops(ops, imgs, labs, gen_host, gen_dev, mask=None, count=None,
             rows=None):
    for name, prob, params in ops:
        imgs, labs = _gated(name, prob, params, imgs, labs, gen_host, gen_dev,
                            mask, count, rows)
    return imgs, labs


def build_batch_aug(recipe: AugRecipe, crop_size):
    """Batched augmentation ``fn(imgs, labs, gen_host, gen_dev, rows=None)
    -> (imgs, labs)``: imgs (B, *buffer, C) float, labs (B, *buffer) int on
    the device -> (B, *crop_size, C), (B, *crop_size); 3D or 2D by the
    length of ``crop_size``.  ``rows`` (``Rows``): the batch is those rows
    of a global batch, every sample's scalars of which are drawn.  The 2D affine is ``random_theta_2d`` (no shear
    ranges of its own: the 2D reference draws shears from the scales).
    An unknown op name raises ``ValueError`` when the batch reaches it, as
    in the JAX package."""
    crop_size = tuple(int(t) for t in crop_size)
    nd = len(crop_size)
    sample = affine_sample_3d_batch if nd == 3 else affine_sample_2d_batch

    def fn(imgs, labs, gen_host, gen_dev, rows=None):
        imgs, labs = _run_ops(recipe.pre_ops, imgs, labs, gen_host, gen_dev,
                              rows=rows)
        thetas = _draw_thetas(recipe, nd, gen_host, imgs.shape[0], rows)
        imgs, labs = sample(imgs, labs, _to_device(thetas, imgs.device),
                            out_shape=crop_size)
        return _run_ops(recipe.post_ops, imgs, labs, gen_host, gen_dev,
                        rows=rows)

    return fn


def build_sample_aug(recipe: AugRecipe, crop_size, ndim: int):
    """Per-sample augmentation ``fn(img_buf, lab_buf, gen_host, gen_dev) ->
    (img, lab)``: img_buf (*buffer, C) float, lab_buf (*buffer) int -> the
    crop.  The batched function on a batch of one (the JAX package's
    per-sample function, which its batched one vmaps)."""
    assert len(crop_size) == ndim, (crop_size, ndim)
    batch_fn = build_batch_aug(recipe, crop_size)

    def fn(img, lab, gen_host, gen_dev):
        out_img, out_lab = batch_fn(img[None], lab[None], gen_host, gen_dev)
        return out_img[0], out_lab[0]

    return fn


def build_fullvol_aug(recipe: AugRecipe, crop_size, margin):
    """The full-volume augmentation ``fn(rows_img, rows_lab, extents,
    starts, gen_host, gen_dev) -> (imgs, labs)`` of ACDC-style recipes on
    the device cache: rows (B, *cache, 1) and (B, *cache) of the cache,
    extents (B, 3) the true volume shapes, starts (B, 3) the crop starts in
    volume coordinates, ``margin`` (3,) the volumes' placement in a row.
    The pre-ops run in fp32 on the whole row, gamma's statistics over the
    true volume, and the row is re-zeroed outside it; the affine spans each
    true volume and its crop box is the only part computed."""
    bad = [nm for (nm, _, _) in recipe.pre_ops if nm not in _FULLVOL_SAFE_PRE]
    if bad:
        raise ValueError(f"full_volume recipe has mask-unsafe pre_ops {bad}; "
                         f"supported: {sorted(_FULLVOL_SAFE_PRE)}")
    crop_size = tuple(int(t) for t in crop_size)
    margin = [int(m) for m in margin]

    def fn(rows_img, rows_lab, extents, starts, gen_host, gen_dev,
           rows=None):
        dev, cache_dtype = rows_img.device, rows_img.dtype
        B, cache = rows_img.shape[0], rows_img.shape[1:4]
        axm = []
        for a in range(3):
            ar = torch.arange(cache[a], device=dev)
            axm.append((ar >= margin[a])
                       & (ar < margin[a] + extents[:, a:a + 1]))
        mask = (axm[0][:, :, None, None] & axm[1][:, None, :, None]
                & axm[2][:, None, None, :])[..., None]
        count = extents.float().prod(1)
        # f32 pre-ops: a single non-finite voxel inside the mask would
        # poison the whole volume through gamma's retain_stats reduction
        imgs, labs = _run_ops(recipe.pre_ops, rows_img.float(), rows_lab,
                              gen_host, gen_dev, mask, count, rows)
        imgs = torch.where(mask, imgs, 0.0)
        thetas = _draw_thetas(recipe, 3, gen_host, B, rows)
        imgs, labs = affine_sample_3d_fullvol_batch(
            imgs.to(cache_dtype), labs, _to_device(thetas, dev), extents,
            starts, margin, crop_size)
        return _run_ops(recipe.post_ops, imgs, labs, gen_host, gen_dev,
                        rows=rows)

    return fn


class TrainPipeline:
    """Window sampler + batched device augmentation, 3D or 2D, on the
    device cache or from host windows (module docstring).

    ``next_batch`` is called after the previous step is queued: the host
    work (the draws, the window copy on the host path) overlaps that step.
    ``device``: the card unless the caller asks for the CPU.  ``mesh``
    (``parallel.make_mesh``): each batch is this rank's rows of the global
    one (module docstring)."""

    def __init__(self, dataset, cfg, seed: int = 0, device="cuda",
                 mesh=None):
        self.ds = dataset
        self.cfg = cfg
        self.ndim = 3 if cfg.dimension == "3d" else 2
        self.crop_size = tuple(cfg.training_size[:self.ndim])
        recipe = dataset.recipe()
        if recipe.num_classes is None:
            recipe = replace(recipe, num_classes=int(cfg.classes))
        if recipe.num_classes - 1 > torch.iinfo(torch.int8).max:
            raise ValueError(f"label ids up to {recipe.num_classes - 1} do "
                             "not fit the int8 label cache and windows")
        self.recipe = recipe
        self.buffer_shape = tuple(
            t + p for t, p in zip(self.crop_size, recipe.affine_pad))
        self.device = get_device(device)
        self.mesh = mesh
        self._rng = np.random.default_rng(seed)
        self._gen_host = torch.Generator().manual_seed(seed)
        self._gen_dev = torch.Generator(device=self.device).manual_seed(
            seed + (mesh.data_rank if mesh is not None else 0))
        self._aug = build_batch_aug(recipe, self.crop_size)
        self._epoch_perm = None
        self._perm_pos = 0
        self.fullvol = False          # set by _init_device_cache when taken
        self.cache_img = None         # the device cache, when taken
        # the native batch assembler copies the 3D host windows (2D
        # batches of slices are small)
        self.native = self.ndim == 3

        mode = cfg.get("device_cache", "auto")
        if mode in (True, "auto") and len(dataset.images) > 0:
            limit = int(cfg.get("device_cache_bytes", 4 << 30))
            cache_shape = tuple(
                max(max(im.shape[ax] for im in dataset.images),
                    self.buffer_shape[ax]) for ax in range(self.ndim))
            total = len(dataset.images) * int(np.prod(cache_shape)) * 5
            if mode is True or total <= limit:
                self._init_device_cache(dataset, cache_shape)

    # -- the device cache -----------------------------------------------------

    def _init_device_cache(self, dataset, cache_shape):
        """Pad every volume into one (n, *cache) array with the JAX
        package's margins (so a window start is margin + virtual start, a
        plain non-negative slice) and move it to the device once."""
        margins, extents = [], []
        for ax, b in enumerate(self.buffer_shape):
            lo_need, hi_need = 0, 0
            for im in dataset.images:
                s = im.shape[ax]
                if s <= b:
                    v_min = v_max = -((b - s) // 2)     # centred placement
                else:
                    m = (b - self.crop_size[ax]) // 2
                    v_min, v_max = -m, s - b + m
                lo_need = max(lo_need, -v_min)
                hi_need = max(hi_need, v_max + b)
            margins.append(lo_need)
            extents.append(lo_need + hi_need)
        self.cache_margin = np.asarray(margins, np.int64)
        cache_shape = tuple(max(c, e) for c, e in zip(cache_shape, extents))
        n = len(dataset.images)
        imgs = np.zeros((n, *cache_shape), np.float32)
        labs = np.zeros((n, *cache_shape), np.int8)
        for i, (im, lb) in enumerate(zip(dataset.images, dataset.labels)):
            box = tuple(slice(lo, lo + s) for lo, s in zip(margins, im.shape))
            imgs[(i, *box)] = im
            labs[(i, *box)] = lb
        name = str(self.cfg.get("cache_dtype", "bfloat16"))
        if name not in _CACHE_DTYPES:
            raise ValueError(f"cache_dtype {name!r}: one of "
                             f"{sorted(_CACHE_DTYPES)}")
        self.cache_img = torch.from_numpy(imgs).to(self.device,
                                                   _CACHE_DTYPES[name])
        self.cache_lab = torch.from_numpy(labs).to(self.device)
        self._vol_shapes = np.array([im.shape for im in dataset.images],
                                    np.int64)

        fv_cfg = self.cfg.get("full_volume")
        fv = self.recipe.full_volume if fv_cfg is None else bool(fv_cfg)
        self.fullvol = bool(fv) and self.ndim == 3
        if self.fullvol:
            self._fullvol_aug = build_fullvol_aug(self.recipe, self.crop_size,
                                                  self.cache_margin)
            self._extents = torch.from_numpy(self._vol_shapes).to(self.device)

    def _cache_starts(self, idxs) -> np.ndarray:
        """Per sample and axis: the window's start in the cache (margin +
        virtual start), or with ``full_volume`` the crop start in volume
        coordinates, randint(0, max(S - ts, 1)) (high end exclusive, the
        reference's crop_3d)."""
        starts = np.zeros((len(idxs), self.ndim), np.int64)
        for i, idx in enumerate(idxs):
            shape = self._vol_shapes[idx]
            for ax in range(self.ndim):
                if self.fullvol:
                    diff = int(shape[ax]) - self.crop_size[ax]
                    starts[i, ax] = self._rng.integers(0, max(diff, 1))
                else:
                    starts[i, ax] = (self.cache_margin[ax]
                                     + self._virtual_start(int(shape[ax]), ax))
        return starts

    def _cache_windows(self, idxs, starts):
        """The batch's (training_size + pad) windows sliced from the cache:
        (B, *buffer, 1) in the cache dtype, (B, *buffer) int8."""
        imgs, labs = [], []
        for idx, st in zip(idxs.tolist(), starts.tolist()):
            box = tuple(slice(s, s + b) for s, b in zip(st, self.buffer_shape))
            imgs.append(self.cache_img[(idx, *box)])
            labs.append(self.cache_lab[(idx, *box)])
        return torch.stack(imgs)[..., None], torch.stack(labs)

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

    def _rows(self, batch_size: int) -> Rows:
        """This rank's rows of a global batch of ``batch_size``."""
        sl = batch_rows(batch_size, self.mesh)
        return Rows(sl.start, sl.stop, batch_size)

    def _host_tensors(self, batch_size: int):
        """(imgs (B, *buffer, 1) float32, labs (B, *buffer) int8) as CPU
        tensors, pinned when the pipeline feeds a CUDA device: this rank's
        rows of a global batch of ``batch_size``, whose windows are all
        drawn."""
        rows = self._rows(batch_size)
        B = rows.stop - rows.start
        pin = self.device.type == "cuda"
        # the assembler writes every byte, zeros included
        alloc = torch.empty if self.native else torch.zeros
        imgs = alloc((B, *self.buffer_shape, 1), dtype=torch.float32,
                     pin_memory=pin)
        labs = alloc((B, *self.buffer_shape), dtype=torch.int8,
                     pin_memory=pin)
        np_imgs, np_labs = imgs.numpy(), labs.numpy()
        idxs = self._draw_indices(batch_size)
        mine, windows = [], []
        for j, idx in enumerate(idxs):
            img, lab = self.ds.images[idx], self.ds.labels[idx]
            starts, sizes, offs = self._window_coords(img.shape)
            i = j - rows.start
            if not 0 <= i < B:
                continue
            if self.native:
                mine.append(idx)
                windows.append(starts + sizes + offs)
                continue
            src = tuple(slice(s0, s0 + w) for s0, w in zip(starts, sizes))
            dst = tuple(slice(o, o + w) for o, w in zip(offs, sizes))
            np_imgs[(i, *dst, 0)] = img[src]
            np_labs[(i, *dst)] = lab[src]
        if self.native:
            from . import native
            native.assemble_batch([self.ds.images[k] for k in mine],
                                  [self.ds.labels[k] for k in mine],
                                  np.asarray(windows, np.int64),
                                  np_imgs[..., 0], np_labs)
        return imgs, labs

    def host_batch(self, batch_size: int):
        """The precrop windows of the host-window path as numpy arrays:
        images (B, *buffer, 1) float32, labels (B, *buffer) int8 (this
        rank's rows under a mesh)."""
        imgs, labs = self._host_tensors(batch_size)
        return imgs.numpy(), labs.numpy()

    # -- device side ----------------------------------------------------------

    def next_batch(self, batch_size: int):
        """(img (B, *crop, 1) float32, lab (B, *crop) int64) on the device:
        under a mesh this rank's B = batch_size // d rows of the global
        batch of ``batch_size``, and under a 'spatial' axis its H slab of
        them (module docstring)."""
        img, lab = self._next_rows(batch_size)
        mesh = self.mesh
        if mesh is None or mesh.spatial_size == 1:
            return img, lab
        dim = 2 if self.ndim == 3 else 1          # H of (B, *crop, C)
        return tuple(slab(t, mesh.spatial_rank, mesh.spatial_size,
                          dim).contiguous() for t in (img, lab))

    def _next_rows(self, batch_size: int):
        """``next_batch``'s rows, whole."""
        rows = self._rows(batch_size) if self.mesh is not None else None
        if self.cache_img is not None:
            idxs = self._draw_indices(batch_size)
            starts = self._cache_starts(idxs)
            if rows is not None:
                idxs = idxs[rows.start:rows.stop]
                starts = starts[rows.start:rows.stop]
            if self.fullvol:
                sel = _to_device(torch.from_numpy(idxs), self.device)
                img, lab = self._fullvol_aug(
                    self.cache_img.index_select(0, sel)[..., None],
                    self.cache_lab.index_select(0, sel),
                    self._extents.index_select(0, sel),
                    _to_device(torch.from_numpy(starts), self.device),
                    self._gen_host, self._gen_dev, rows)
            else:
                imgs, labs = self._cache_windows(idxs, starts)
                img, lab = self._aug(imgs, labs, self._gen_host,
                                     self._gen_dev, rows)
            return img.float(), lab.long()
        imgs, labs = self._host_tensors(batch_size)
        imgs = imgs.to(self.device, non_blocking=True)
        labs = labs.to(self.device, non_blocking=True).long()
        return self._aug(imgs, labs, self._gen_host, self._gen_dev, rows)
