"""Per-epoch LR schedules (counterpart of ``cbim_tpu/training/schedules.py``,
reference training/utils.py:50-93).  The trainer sets the value on the
optimizer's param groups once per epoch."""

from __future__ import annotations


def exp_lr_scheduler_with_warmup(init_lr: float, epoch: int, warmup_epoch: int,
                                 max_epoch: int) -> float:
    """exp warmup (base 2.718, as literally written in the reference) then
    poly(0.9) decay (training/utils.py:77-93)."""
    if 0 <= epoch <= warmup_epoch and warmup_epoch != 0:
        if epoch == warmup_epoch:
            return init_lr
        return init_lr * 2.718 ** (10 * (float(epoch) / float(warmup_epoch) - 1.0))
    return init_lr * (1 - epoch / max_epoch) ** 0.9
