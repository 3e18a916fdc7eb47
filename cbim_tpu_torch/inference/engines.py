"""Inference engines: whole-image, 3D sliding-window and the 2D slice-batch
sliding window (counterpart of ``cbim_tpu/inference/engines.py``).

Same window geometry and fusion as ``cbim_tpu`` (and the reference's
inference3d.py): stride half a window, edge windows clamped flush to the
border (``split_idx``), repeated starts run once and weighted by their
multiplicity (``_dedup_starts``), softmax probabilities summed and divided
by the visit count; inputs smaller than the window are zero-padded on the
high side and cropped back.  ``fusion`` "uniform" (the reference's) weighs
every voxel of a window alike; "gaussian" (the config's
``window_fusion``, the nnU-Net-style centre weighting the JAX package
offers) weighs each window's probabilities by a separable Gaussian
importance map and divides by the importance-weighted count map.

PyTorch runs eagerly, so the sweep is a Python loop over window groups under
``torch.inference_mode()`` instead of a compiled scan; a short last group
runs as it is (no padded forwards), but for a model whose eval forward
normalises with its batch's statistics (VNet's ContBatchNorm,
``batch_statistics``): there the group is filled up with the first
window, weighted 0, as the JAX engine pads every group, so that each
window sees the same batch as in JAX.  The probability accumulator is an
fp32 buffer on the device, updated in place; the importance map and the
count map are pure window geometry, built on the host once (the count map
per padded shape) and cached on the device.

The 2D sweep (``sliding_window_slices``) runs every slice of a volume as
the batch at each window position, with the same window grid, dedup,
count map and pad/crop rules.  It keeps the JAX package's semantics: the
whole volume is one batch, never split behind the caller's back, so a
volume too large for the card raises the allocator's out-of-memory error.

The public functions take and return ``cbim_tpu``'s layout (B, *spatial, C);
``apply_fn`` takes and returns NC(D)HW.

The sharded variants (``*_sharded``) split one call's work over the ranks
of a node under data parallelism (``parallel.make_mesh``; JAX shards over
a host's 'data' devices): each rank runs its share with no autograd and the
shares meet in one collective over ``mesh.node_group``.  Every rank returns
the whole result.  ``whole_image_sharded`` and
``sliding_window_slices_sharded`` split the rows (slices), padded to a
multiple of the node's W and all-gathered; ``sliding_window_sharded`` gives
each rank contiguous window groups (the group count padded to a multiple
of W, the padding groups empty), sums the ranks' accumulators and divides
by the count map, as the JAX ``shard_map`` sweep ``psum``s them.  A
batch-statistics model (VNet) then normalises each rank's rows or group on
its own, as each JAX device does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import compute_dtype
from ..models.layers.convs import CHANNELS_LAST
from ..parallel.collectives import all_gather_rows


def split_idx(half_win: int, size: int, i: int):
    """Exact port of reference inference/utils.py:29-43."""
    start = half_win * i
    end = start + half_win * 2
    if end > size:
        start = size - half_win * 2
        end = size
    return start, end


def _grid_starts(spatial, window):
    """All window start coordinates for a volume (reference's triple loop)."""
    halves = [w // 2 for w in window]
    axes = []
    for size, half in zip(spatial, halves):
        axes.append([split_idx(half, size, i)[0] for i in range(size // half)])
    starts = np.stack(np.meshgrid(*axes, indexing="ij"),
                      axis=-1).reshape(-1, len(window))
    return starts.astype(np.int32)


def _dedup_starts(starts: np.ndarray):
    """Collapse repeated window starts into (unique_starts, multiplicity);
    np.unique's sorted order keeps the reference's visit order."""
    uniq, mult = np.unique(starts, axis=0, return_counts=True)
    return uniq.astype(np.int32), mult.astype(np.float32)


def _auto_window_batch(n_windows: int, cap: int = 6) -> int:
    """Largest window_batch <= cap that divides the unique-window count
    (2 when nothing in [2, cap] does)."""
    for wb in range(cap, 1, -1):
        if n_windows % wb == 0:
            return wb
    return 2


#: the fusions, and the Gaussian's sigma as a share of the window side
#: (fixed, as in ``cbim_tpu``: not a config key)
FUSIONS = ("uniform", "gaussian")
GAUSSIAN_SIGMA_SCALE = 0.125


def importance_map(window, fusion: str = "uniform") -> np.ndarray:
    """The weight of each voxel of a window, (*window) fp32, built on the
    host as ``cbim_tpu``'s ``_importance``: ones for uniform fusion; for
    gaussian the separable exp(-x^2 / (2 sigma^2)) about the window's centre
    (sigma = max(side * GAUSSIAN_SIGMA_SCALE, 1e-3)), scaled to a maximum
    of 1 and floored at 1e-3 of it, so that every count stays positive."""
    if fusion == "uniform":
        return np.ones(tuple(window), np.float32)
    maps = []
    for w in window:
        x = np.arange(w, dtype=np.float32) - (w - 1) / 2.0
        sigma = max(w * GAUSSIAN_SIGMA_SCALE, 1e-3)
        maps.append(np.exp(-0.5 * (x / sigma) ** 2))
    imp = maps[0][:, None] * maps[1][None, :] if len(window) == 2 else \
        maps[0][:, None, None] * maps[1][None, :, None] * \
        maps[2][None, None, :]
    imp = imp / imp.max()
    imp = np.maximum(imp, imp.max() * 1e-3)
    return imp.astype(np.float32)


def _softmax_fp32(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=1)


def _window(start, window) -> tuple:
    """Index of one window in an NCDHW tensor."""
    return (slice(None), slice(None),
            *(slice(int(o), int(o) + w) for o, w in zip(start, window)))


class InferenceEngine:
    """Sliding-window and whole-image inference around ``apply_fn``.

    ``apply_fn(x) -> logits``: NCDHW in, NCDHW out (deep-supervision heads
    already reduced to head 0 by the caller).  ``fusion``: "uniform" or
    "gaussian" (:func:`importance_map`)."""

    def __init__(self, apply_fn, num_classes: int, window_size=None,
                 window_batch: int | str | None = 1,
                 pad_groups: bool = False, fusion: str = "uniform"):
        if fusion not in FUSIONS:
            raise ValueError(f"unknown window fusion {fusion!r}; the "
                             f"fusions are {FUSIONS}")
        self.apply_fn = apply_fn
        self.pad_groups = pad_groups
        self.num_classes = num_classes
        self.window_size = tuple(window_size) if window_size else None
        # None/"auto": pick per volume shape
        self.window_batch = (None if window_batch in (None, "auto")
                             else max(1, int(window_batch)))
        self.fusion = fusion
        self._cnt_cache = {}
        self._imp_cache = {}

    def _importance(self, device) -> torch.Tensor | None:
        """The window's importance map on ``device``, (1, *window) so that
        it broadcasts over the classes; None for uniform fusion (weight 1
        everywhere, nothing to multiply)."""
        if self.fusion == "uniform":
            return None
        imp = self._imp_cache.get(device)
        if imp is None:
            imp = self._imp_cache[device] = torch.from_numpy(importance_map(
                self.window_size, self.fusion))[None].to(device)
        return imp

    def _pad_and_grid(self, x: torch.Tensor):
        """x (B, C, *spatial) zero-padded on the high side up to the window
        (reference inference3d.py:44-54); returns (x, padded spatial,
        unique window starts, their multiplicity, the count map on x's
        device)."""
        window = self.window_size
        pads = [max(0, w - s) for s, w in zip(x.shape[2:], window)]
        if any(pads):
            # F.pad orders its pairs from the last axis backwards
            x = F.pad(x, [p for pad in reversed(pads) for p in (0, pad)])
        padded = tuple(x.shape[2:])
        starts, mult = _dedup_starts(_grid_starts(padded, window))
        cnt = self._cnt_cache.get((padded, x.device))
        if cnt is None:
            cnt = torch.from_numpy(self._count_map(padded, starts, mult))
            cnt = self._cnt_cache[(padded, x.device)] = cnt.to(x.device)
        return x, padded, starts, mult, cnt

    def _count_map(self, padded_spatial, starts, mult):
        """The fusion denominator, (1, 1, *padded_spatial): each voxel's
        window visits times the window's importance there, pure geometry,
        built on the host."""
        imp = importance_map(self.window_size, self.fusion)
        cnt = np.zeros((1, 1, *padded_spatial), np.float32)
        for s, m in zip(starts, mult):
            cnt[_window(s, self.window_size)] += m * imp
        return cnt

    # -- whole image --------------------------------------------------------
    def whole_image(self, img: torch.Tensor) -> torch.Tensor:
        """img: (B, *spatial, C) -> softmax probs (B, *spatial, classes)."""
        with torch.inference_mode():
            probs = _softmax_fp32(self.apply_fn(img.movedim(-1, 1)))
        return probs.movedim(1, -1)

    def whole_image_sharded(self, img: torch.Tensor, mesh) -> torch.Tensor:
        """:meth:`whole_image` with the rows of ``img`` (a 2D test volume's
        slices) split over the node's ranks: padded with zero rows to a
        multiple of W, each rank's contiguous share run, the shares
        all-gathered and the padding dropped."""
        return self._rows_sharded(self.whole_image, img, mesh)

    def _rows_sharded(self, fn, img: torch.Tensor, mesh) -> torch.Tensor:
        """``fn`` (rows in, rows out) over this rank's share of ``img``'s
        rows, the node's shares all-gathered in rank order."""
        group = mesh.node_group
        W, r = dist.get_world_size(group), dist.get_rank(group)
        B = img.shape[0]
        pad = (-B) % W
        if pad:
            img = torch.cat([img, img.new_zeros((pad, *img.shape[1:]))])
        n = img.shape[0] // W
        with torch.inference_mode():
            probs = all_gather_rows(fn(img[r * n:(r + 1) * n]), group)
        return probs[:B]

    # -- sliding window -------------------------------------------------------
    def sliding_window(self, img: torch.Tensor) -> torch.Tensor:
        """img: (1, *spatial, C) -> softmax probs (1, *spatial, classes)."""
        return self._sliding_window(img)

    def sliding_window_sharded(self, img: torch.Tensor, mesh
                               ) -> torch.Tensor:
        """:meth:`sliding_window` with the window groups split over the
        node's ranks: the groups of ``window_batch`` windows (the
        unsharded call's) padded with empty groups to a multiple of W, rank
        r sweeping the r-th contiguous share into its own accumulator, the
        accumulators summed over the node (one ``all_reduce``) and divided
        by the host's count map, as ``cbim_tpu``'s shard_map sweep
        ``psum``s them.  Every rank returns the whole volume's
        probabilities; they equal :meth:`sliding_window`'s up to the fp32
        summation order of overlapping windows."""
        return self._sliding_window(img, mesh.node_group)

    def _sliding_window(self, img: torch.Tensor, group=None) -> torch.Tensor:
        window = self.window_size
        spatial = tuple(img.shape[1:1 + len(window)])
        x, padded, starts, mult, cnt = self._pad_and_grid(img.movedim(-1, 1))
        wb = self.window_batch or _auto_window_batch(len(starts))
        imp = self._importance(x.device)
        firsts = range(0, len(starts), wb)
        if group is not None:
            W, r = dist.get_world_size(group), dist.get_rank(group)
            per = -(-len(firsts) // W)
            firsts = firsts[r * per:(r + 1) * per]

        with torch.inference_mode():
            acc = torch.zeros((1, self.num_classes, *padded),
                              dtype=torch.float32, device=x.device)
            for g in firsts:
                grp = starts[g:g + wb]
                fill = [starts[0]] * (wb - len(grp)) if self.pad_groups \
                    else []
                wins = torch.cat([x[_window(s, window)]
                                  for s in [*grp, *fill]])
                probs = _softmax_fp32(self.apply_fn(wins))
                if imp is not None:
                    probs *= imp
                for i, s in enumerate(grp):
                    acc[_window(s, window)] += probs[i] * float(mult[g + i])
            if group is not None:
                dist.all_reduce(acc, group=group)
            acc /= cnt
        crop = (slice(None), slice(None), *(slice(0, s) for s in spatial))
        return acc[crop].movedim(1, -1)

    # -- sliding window, 2D slice-batch form ----------------------------------
    def sliding_window_slices(self, img: torch.Tensor) -> torch.Tensor:
        """2D sliding window over a slice batch: img (B, H, W, C_in) ->
        probs (B, H, W, classes).

        Reference inference/inference2d.py:27-71: all B slices of the volume
        ride as the batch through the net at each window position.  Inputs
        smaller than the window are zero-padded and cropped back, as the JAX
        package does (the reference would fail on them)."""
        window = self.window_size
        if window is None or len(window) != 2:
            raise ValueError(f"sliding_window_slices needs a 2D window, "
                             f"got {window}")
        spatial = tuple(img.shape[1:3])
        x, padded, starts, mult, cnt = self._pad_and_grid(img.movedim(-1, 1))
        imp = self._importance(x.device)

        with torch.inference_mode():
            acc = torch.zeros((x.shape[0], self.num_classes, *padded),
                              dtype=torch.float32, device=x.device)
            for s, m in zip(starts, mult):
                probs = _softmax_fp32(self.apply_fn(x[_window(s, window)]))
                if imp is not None:
                    probs *= imp
                acc[_window(s, window)] += probs * float(m)
            acc /= cnt
        return acc[:, :, :spatial[0], :spatial[1]].movedim(1, -1)

    def sliding_window_slices_sharded(self, img: torch.Tensor, mesh
                                      ) -> torch.Tensor:
        """:meth:`sliding_window_slices` with the slices split over the
        node's ranks (padded with zero slices to a multiple of W, each
        rank's share swept, the shares all-gathered, the padding
        dropped)."""
        return self._rows_sharded(self.sliding_window_slices, img, mesh)


def make_engine(model, cfg, window_batch: int | str | None = None
                ) -> InferenceEngine:
    """Wrap a model into an InferenceEngine: inputs cast to the model's
    dtype in the model's channels-last memory format, head 0 of
    deep-supervision models (reference inference3d.py:22-24).  A model
    held in fp32 for training whose config computes in bf16 runs under bf16
    autocast on CUDA, as its train step does (validation's forward).  The
    config's ``window_fusion`` (default uniform) picks the fusion, so the
    prediction CLI and validation both take it."""
    dtype = next(model.parameters()).dtype
    memory_format = CHANNELS_LAST[2 if cfg.dimension == "2d" else 3]
    amp = dtype == torch.float32 and compute_dtype(cfg) == torch.bfloat16

    def apply_fn(x):
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=amp and x.is_cuda):
            out = model(x.to(dtype).contiguous(memory_format=memory_format))
        return out[0] if isinstance(out, (tuple, list)) else out

    wb = window_batch if window_batch is not None \
        else cfg.get("window_batch", "auto")
    return InferenceEngine(apply_fn, cfg.classes,
                           window_size=cfg.get("window_size"), window_batch=wb,
                           pad_groups=getattr(model, "batch_statistics",
                                              False),
                           fusion=cfg.get("window_fusion", "uniform"))
