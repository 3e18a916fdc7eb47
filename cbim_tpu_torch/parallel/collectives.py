"""The collectives of data parallelism.

:func:`all_reduce_sum` is a sum across the ranks that autograd
differentiates: its backward sums the incoming gradients across the ranks
too.  The loss and the BatchNorm statistics of the global batch take their
sums through it, so every rank holds the same global loss; autograd then
gives each rank W times the gradient of that loss through its own rows,
and ``DistributedDataParallel``'s mean over the W ranks is the gradient of
the global batch's loss, as the JAX mesh computes it.
(``torch.distributed.nn.functional.all_reduce`` does the same and is
deprecated.)
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable; the
    identity without a group."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along axis 0, in rank
    order; no autograd."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
