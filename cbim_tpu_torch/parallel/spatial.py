"""The 'spatial' mesh axis: the volume's H axis sharded over a group of
ranks (counterpart of the JAX package's ``P(..., "spatial" on H, ...)``
train step, ``cbim_tpu/training/trainer.py:54-99``).

JAX's partitioner inserts the halo exchanges and the reductions; here each
op that crosses H is written out, on the helpers of this module:

- :func:`slab`: a rank's rows of H, the ``j``-th of ``s`` equal slabs;
- :func:`halo`: a slab with ``h`` planes of each neighbour on either side,
  none at the volume's two ends (where a SAME conv pads its input with
  zeros itself), differentiable: its backward adds each halo's gradient
  into the neighbour's boundary planes.  :func:`halo_conv` runs a stride-1
  SAME conv on the haloed slab and keeps its own rows, which is the
  unsharded conv's output on them;
- :func:`exchange` and :func:`exchange_transpose`, the same two moves on a
  tensor of any layout, for the autograd Functions that save their own
  inputs (the fused preact conv);
- :func:`group_softmax`, a softmax over the group's slabs (MedFormer's
  over space), on :func:`group_max` (no gradient); :func:`group_sum` (no
  gradient; the differentiable sum is ``collectives.all_reduce_sum``) and
  :func:`gather_pairs`, every rank's pair of tensors in one collective
  (InstanceNorm's slab statistics).

Every move is one ``all_gather`` of each rank's two boundary slabs, as raw
bytes: gloo and NCCL both carry it, for CPU and CUDA tensors and any
dtype (gloo's ``send``/``recv`` takes no CUDA tensor).  Each rank then
keeps what its two neighbours sent.  At s = 2 that is all it receives; at
larger s it receives the others' boundaries too, s planes where a
neighbour-to-neighbour exchange would move 2.

The H axis is the second-to-last of a (B, C, *spatial) tensor: dim 3 of
(B, C, D, H, W), dim 2 of (B, C, H, W).  A model's layers find their group
through the ``spatial_group`` slot that ``layers.convs.spatial_shard``
marks, in training mode only: evaluation shards windows, never H.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .collectives import all_reduce_sum


def rank_and_size(group) -> tuple[int, int]:
    """(this rank's slab index, the slab count) in ``group``."""
    return dist.get_rank(group), dist.get_world_size(group)


def h_axis(x: torch.Tensor) -> int:
    """The H axis of a (B, C, *spatial) tensor: the second-to-last."""
    return x.dim() - 2


def slab(x: torch.Tensor, index: int, count: int, dim: int) -> torch.Tensor:
    """Rows ``[index * n, (index + 1) * n)`` of ``dim``, n = size / count
    (``count`` must divide the size)."""
    size = x.shape[dim]
    if size % count:
        raise ValueError(f"an axis of {size} does not split into {count} "
                         "equal slabs")
    n = size // count
    return x.narrow(dim, index * n, n)


def gather_pairs(first: torch.Tensor, second: torch.Tensor, group
                 ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Every rank's (first, second), equal shapes and dtypes, in rank
    order: one ``all_gather`` of both as bytes."""
    pack = torch.stack([first, second]).contiguous()
    raw = pack.view(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    return [tuple(p.view(pack.dtype).view(pack.shape)) for p in parts]


def exchange(x: torch.Tensor, h: int, group, dim: int
             ) -> tuple[torch.Tensor, int, int]:
    """``x`` (any layout) with ``h`` rows of ``dim`` of each neighbouring
    slab on either side: (the haloed tensor, contiguous; the rows added
    before; the rows added after).  The first and last slabs get none on
    their outer side."""
    j, s = rank_and_size(group)
    n = x.shape[dim]
    if h > n:
        raise ValueError(f"a halo of {h} rows exceeds the slab's {n}")
    pairs = gather_pairs(x.narrow(dim, 0, h), x.narrow(dim, n - h, h),
                          group)
    parts = [x]
    pre = post = 0
    if j > 0:
        parts.insert(0, pairs[j - 1][1])        # the previous slab's last
        pre = h
    if j < s - 1:
        parts.append(pairs[j + 1][0])           # the next slab's first
        post = h
    return torch.cat(parts, dim), pre, post


def exchange_transpose(g: torch.Tensor, pre: int, post: int, h: int, group,
                       dim: int) -> torch.Tensor:
    """The transpose of :func:`exchange`: ``g`` over the haloed rows ->
    the slab's gradient, each halo's rows added into the boundary rows of
    the neighbour they came from."""
    n = g.shape[dim] - pre - post
    zeros = g.new_zeros(g.narrow(dim, 0, h).shape)
    to_prev = g.narrow(dim, 0, pre) if pre else zeros
    to_next = g.narrow(dim, pre + n, post) if post else zeros
    pairs = gather_pairs(to_prev, to_next, group)
    j, s = rank_and_size(group)
    dx = g.narrow(dim, pre, n).clone()
    if j > 0:
        dx.narrow(dim, 0, h).add_(pairs[j - 1][1])
    if j < s - 1:
        dx.narrow(dim, n - h, h).add_(pairs[j + 1][0])
    return dx


class _Halo(torch.autograd.Function):
    """:func:`exchange` with :func:`exchange_transpose` as its backward."""

    @staticmethod
    def forward(ctx, x, h, group, dim):
        xh, pre, post = exchange(x, h, group, dim)
        ctx.args = (pre, post, h, group, dim)
        return xh

    @staticmethod
    def backward(ctx, g):
        pre, post, h, group, dim = ctx.args
        return exchange_transpose(g, pre, post, h, group, dim), None, None, \
            None


def halo(x: torch.Tensor, h: int, group) -> tuple[torch.Tensor, int]:
    """(x (B, C, *spatial), an H slab, with ``h`` planes of each neighbour
    on either side; the planes added before), differentiable.  Exchanged
    in channels-last order, which the result keeps."""
    j, s = rank_and_size(group)
    xh = _Halo.apply(x.movedim(1, -1), h, group, h_axis(x) - 1)
    return xh.movedim(-1, 1), (h if j > 0 else 0)


def halo_conv(fn, x: torch.Tensor, kernel_h: int, group) -> torch.Tensor:
    """A stride-1 SAME conv ``fn`` of an H slab ``x`` (B, C, *spatial) whose
    kernel spans ``kernel_h`` rows of H: ``fn`` of the slab with (kernel_h
    - 1) / 2 planes of each neighbour, the added rows of its output
    dropped, which is the unsharded conv's output on the slab's rows.  A
    kernel of one row needs no neighbour."""
    h = (kernel_h - 1) // 2
    if h == 0:
        return fn(x)
    xh, pre = halo(x, h, group)
    return fn(xh).narrow(h_axis(x), pre, x.shape[h_axis(x)])


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, no gradient (a new tensor)."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def group_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group``, no gradient: the shift
    that keeps a softmax over the group's slabs in range (any shift gives
    the same softmax)."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def group_softmax(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The softmax of ``t`` along ``dim``, whose entries the ranks of
    ``group`` share out (each its slab's tokens or voxels), differentiable:
    shifted by the group's max, normalised by the group's sum
    (``collectives.all_reduce_sum``)."""
    e = torch.exp(t - group_max(t.amax(dim, keepdim=True), group))
    return e / all_reduce_sum(e.sum(dim, keepdim=True), group)
