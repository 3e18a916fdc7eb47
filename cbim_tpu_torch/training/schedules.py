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


def multistep_lr_scheduler_with_warmup(init_lr: float, epoch: int,
                                       warmup_epoch: int, lr_decay_epoch,
                                       max_epoch: int, gamma: float = 0.1,
                                       current_lr: float | None = None) -> float:
    """exp warmup, then init_lr * gamma^(i + 1) at the i-th epoch of
    ``lr_decay_epoch`` and ``current_lr`` (else init_lr) between them
    (training/utils.py:50-75; no trainer of the reference calls it)."""
    if 0 <= epoch <= warmup_epoch:
        if epoch == warmup_epoch:
            return init_lr
        return init_lr * 2.718 ** (10 * (float(epoch) / float(warmup_epoch) - 1.0))
    for i, de in enumerate(lr_decay_epoch):
        if epoch == de:
            return init_lr * gamma ** (i + 1)
    return current_lr if current_lr is not None else init_lr
