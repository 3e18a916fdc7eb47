"""Validation loop (counterpart of ``cbim_tpu/training/validation.py``;
reference training/validation.py:16-87).

Per test volume: inference (whole-image or sliding-window) on the model's
device, argmax there, the int label map copied to the host, per-class Dice
from the confusion counts, ASD/HD95 on the host, NaN/inf clipped to 500,
and only the classes present in the ground truth averaged.  2D models
evaluate a volume by batching its slices (validation.py:39-40).

The forward runs in the recipe's compute dtype, as the JAX package's does:
``make_engine`` puts an fp32 (trained) model under bf16 autocast when the
config asks for bf16.

Under data parallelism (``mesh``) JAX's process is the port's node and
JAX's 'data' devices of a host are the node's ranks: each node takes every
n-th volume (``cbim_tpu`` validation.py:72-78), the node's ranks sweep each
of its volumes together with the engine's ``*_sharded`` methods, the
node's first rank scores it, and the per-class sums and counts are summed
over every rank in float64 (JAX's ``process_allgather``, :123-135), so
that every rank returns the same dice, asd and hd.  JAX's case of striding
volumes over processes while sharding each over a mesh that spans those
processes has no counterpart.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from ..inference.engines import make_engine
from ..ops.metrics import calculate_distance


def dice_from_confusion(pred: np.ndarray, target: np.ndarray,
                        num_classes: int) -> np.ndarray:
    """2*|P∩T| / (|P|+|T| + 1e-5) per class (reference
    metric/utils.py:62-82), from the confusion counts on the host."""
    pred = pred.reshape(-1).astype(np.int64)
    target = target.reshape(-1).astype(np.int64)
    inter = np.bincount(pred[pred == target],
                        minlength=num_classes)[:num_classes]
    p_count = np.bincount(pred, minlength=num_classes)[:num_classes]
    t_count = np.bincount(target, minlength=num_classes)[:num_classes]
    return 2.0 * inter / (p_count + t_count + 1e-5)


def filter_validation_results(dice, asd, hd, cfg):
    """amos_mr's validation set lacks the last two organs
    (training/utils.py:43-48)."""
    if cfg.dataset == "amos_mr":
        return dice[:-2], asd[:-2], hd[:-2]
    return dice, asd, hd


def predict_labels(engine, img: np.ndarray, cfg, device,
                   mesh=None) -> np.ndarray:
    """The label map (uint8, img's shape) of one test volume: the volume to
    ``device``, the engine's softmax and its argmax there, the labels to
    the host.  With a ``mesh`` of more than one rank on the node the sweep
    is the engine's sharded one (a 3D whole image stays whole, as in
    JAX)."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)
    sharded = mesh is not None and mesh.local_size > 1
    if cfg.dimension == "2d":
        inputs = x[..., None]                         # (D, H, W, 1): slices
        if sharded:
            probs = (engine.sliding_window_slices_sharded(inputs, mesh)
                     if cfg.sliding_window
                     else engine.whole_image_sharded(inputs, mesh))
        else:
            probs = (engine.sliding_window_slices(inputs)
                     if cfg.sliding_window else engine.whole_image(inputs))
    else:
        inputs = x[None, ..., None]                   # (1, D, H, W, 1)
        if cfg.sliding_window:
            probs = (engine.sliding_window_sharded(inputs, mesh) if sharded
                     else engine.sliding_window(inputs))
        else:
            probs = engine.whole_image(inputs)
        probs = probs[0]
    return probs.argmax(-1).to(torch.uint8).cpu().numpy()


def validate(model: torch.nn.Module, testset, cfg, engine=None, mesh=None):
    """Returns (dice, asd, hd) arrays of length classes-1 (background
    excluded): each class's mean over the test volumes whose ground truth
    holds it, NaN where none does.

    ``model`` is evaluated in eval mode (its mode is restored after);
    ``engine`` is an ``InferenceEngine`` around it (``make_engine``), built
    here when not given: the trainer keeps one per fold, and the EMA module
    it wraps is updated in place between evaluations.  ``mesh``
    (``parallel.make_mesh``): every rank of the run calls it and gets the
    same result (module docstring).
    """
    if engine is None:
        engine = make_engine(model, cfg)
    device = next(model.parameters()).device
    C = cfg.classes
    dice_acc = [[] for _ in range(C - 1)]
    asd_acc = [[] for _ in range(C - 1)]
    hd_acc = [[] for _ in range(C - 1)]

    logging.info("Evaluating (%d volumes)", len(testset))
    was_training = model.training
    model.eval()
    # the node's first rank scores what the node's ranks sweep
    scores = mesh is None or mesh.local_rank == 0
    try:
        for idx in range(len(testset)):
            if mesh is not None and idx % mesh.nodes != mesh.node:
                continue
            img, lab, spacing = testset.test_item(idx)
            pred = predict_labels(engine, img, cfg, device, mesh)
            if not scores:
                continue
            lab = np.asarray(lab)
            tmp_asd, tmp_hd = calculate_distance(pred, lab, spacing, C)
            # NaN/inf -> 500 clip (validation.py:59-60)
            tmp_asd = np.clip(np.nan_to_num(tmp_asd, nan=500, posinf=500),
                              0, 500)
            tmp_hd = np.clip(np.nan_to_num(tmp_hd, nan=500, posinf=500),
                             0, 500)
            dice = dice_from_confusion(pred, lab, C)[1:]

            present = set(np.unique(lab).tolist())
            for cls in range(C - 1):
                if (cls + 1) in present:      # only GT-present classes count
                    dice_acc[cls].append(dice[cls])
                    asd_acc[cls].append(tmp_asd[cls])
                    hd_acc[cls].append(tmp_hd[cls])
    finally:
        model.train(was_training)

    if mesh is not None:
        def row(acc):
            return [[float(np.sum(d)), len(d)] for d in acc]

        sums = torch.tensor([row(dice_acc), row(asd_acc), row(hd_acc)],
                            dtype=torch.float64, device=mesh.device)
        dist.all_reduce(sums, group=mesh.group)
        total = sums.cpu().numpy()        # (3, C-1, 2)
        with np.errstate(invalid="ignore"):
            out = total[..., 0] / total[..., 1]
        return out[0], out[1], out[2]

    out_dice = np.array([np.mean(d) if d else np.nan for d in dice_acc])
    out_asd = np.array([np.mean(d) if d else np.nan for d in asd_acc])
    out_hd = np.array([np.mean(d) if d else np.nan for d in hd_acc])
    return out_dice, out_asd, out_hd
