"""Segmentation losses (counterpart of ``cbim_tpu/ops/losses.py``).

- ``dice_loss``: softmax -> one-hot -> adaptive Tversky weighting
  alpha = FP/(FP+FN) clipped to [0.2, 0.8], beta = 1 - alpha, smooth 1e-5,
  mean over classes (reference training/losses.py:8-58).
- ``weighted_cross_entropy``: ``F.cross_entropy(weight=w)``, torch's
  weighted mean, which the JAX package re-derives.
- ``focal_loss``: class-balanced, gamma 2 (reference losses.py:60-98).

Layout: ``logits`` are NCDHW (B, C, *spatial), as the port's models return
them; ``target`` is an integer tensor (B, *spatial) in [0, C).  All sums and
the adaptive-alpha division run in fp32 whatever the compute dtype.

``group``: under data parallelism each rank holds its rows of the global
batch, and every loss is the global batch's, as on the JAX mesh: the sums
over the batch (Dice's tp, fp and fn; the cross entropy's weighted sum and
weight; the focal loss's sum and count) cross the ranks through
``parallel.all_reduce_sum`` before they are combined.  The mean of per-rank
Dice losses would be another loss.  Without a group nothing changes.
Under the 'spatial' mesh axis each rank holds an H slab of its rows, and
the same world-group sums (counts included) cover every slab's voxels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_sum

_SMOOTH = 1e-5


def _one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, *spatial) ints -> (B, C, *spatial) fp32 one-hot."""
    return F.one_hot(target.long(), num_classes).movedim(-1, 1).float()


def dice_loss(logits: torch.Tensor, target: torch.Tensor,
              group=None) -> torch.Tensor:
    """Adaptive-Tversky Dice loss, mean over classes; logits (B, C,
    *spatial)."""
    num_classes = logits.shape[1]
    dims = [0, *range(2, logits.dim())]
    probs = torch.softmax(logits.float(), dim=1)
    onehot = _one_hot(target, num_classes)
    tp = (probs * onehot).sum(dims)
    fp = (probs * (1.0 - onehot)).sum(dims)
    fn = ((1.0 - probs) * onehot).sum(dims)
    if group is not None:
        tp, fp, fn = all_reduce_sum(torch.stack([tp, fp, fn]), group)

    alpha = (fp / (fp + fn + _SMOOTH)).clamp(0.2, 0.8)
    beta = 1.0 - alpha
    dice = tp / (tp + alpha * fp + beta * fn + _SMOOTH)

    return (1.0 - dice).sum() / num_classes


def weighted_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                           class_weights=None, group=None) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss(weight=w): sum(w[t] * ce) / sum(w[t])."""
    w = None
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=torch.float32,
                            device=logits.device)
    if group is None:
        return F.cross_entropy(logits.float(), target.long(), weight=w)
    t = target.long()
    # reduction "none" weighs each voxel's ce by w[t] already
    num = F.cross_entropy(logits.float(), t, weight=w, reduction="none").sum()
    den = (w[t].sum() if w is not None else
           torch.tensor(float(t.numel()), device=logits.device))
    num, den = all_reduce_sum(torch.stack([num, den]), group)
    return num / den


def focal_loss(logits: torch.Tensor, target: torch.Tensor, *,
               gamma: float = 2.0, alpha=None, group=None) -> torch.Tensor:
    """Focal loss matching reference FocalLoss (training/losses.py:60-98)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    t = target.long().unsqueeze(1)
    logpt = logp.gather(1, t).squeeze(1)
    pt = logpt.exp()
    a = 1.0
    if alpha is not None:
        a = torch.as_tensor(alpha, dtype=torch.float32,
                            device=logits.device)[target.long()]
    batch_loss = -a * (1.0 - pt) ** gamma * logpt
    if group is None:
        return batch_loss.mean()
    total, count = all_reduce_sum(torch.stack([
        batch_loss.sum(), torch.tensor(float(batch_loss.numel()),
                                       device=logits.device)]), group)
    return total / count


def segmentation_loss(logits, target, class_weights=None, rlt: float = 1.0,
                      group=None):
    """CE + Dice as the reference train loop combines them (train.py:199);
    ``rlt`` weights the CE term."""
    return (rlt * weighted_cross_entropy(logits, target, class_weights, group)
            + dice_loss(logits, target, group))


def deep_supervision_loss(outputs, target, aux_weight, class_weights=None,
                          rlt: float = 1.0, group=None):
    """Sum of per-head (CE + Dice) weighted by ``aux_weight``
    (train.py:194-212); ``outputs`` are full-resolution logits."""
    loss = 0.0
    for w, out in zip(aux_weight, outputs):
        loss = loss + w * segmentation_loss(out, target, class_weights, rlt,
                                            group)
    return loss
