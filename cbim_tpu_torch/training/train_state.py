"""Train state and the train step (counterpart of
``cbim_tpu/training/train_state.py``).

One step: forward under ``torch.autocast`` (bf16 when cfg asks for amp, on
CUDA), CE + Dice with deep supervision, backward, the optimizer step, and
the per-step EMA update (reference training/utils.py:98-105): the EMA
averages the parameters and copies the buffers (BatchNorm's running
statistics), as the JAX step copies ``batch_stats`` into its EMA state.  The
live model trains in train mode (BatchNorm normalises with batch
statistics and updates its running ones); the EMA copy stays in eval mode,
the mode it is evaluated in.  Parameters,
gradients and optimizer state stay fp32, as in the JAX package; bf16 needs
no GradScaler.  Unlike the JAX step, which returns a new state, this one
updates the model, the optimizer state and the EMA copy in place.

Under data parallelism (``mesh``, ``parallel.make_mesh``) each rank steps
on its rows of the global batch: the live model trains wrapped in
``DistributedDataParallel`` (the EMA copy never is), the loss is the global
batch's (``ops.losses``'s ``group``), every BatchNorm normalises with the
global batch's statistics (``layers.convs.sync_batch_norm``), and DDP's
mean over the ranks of W times each rank's gradient is the global loss's
gradient, as on the JAX mesh.

Under a 'spatial' mesh axis each rank holds an H slab of its data index's
rows: the live model is marked for it (``layers.convs.spatial_shard``:
halo exchanges, statistics and softmaxes over the spatial group), and the
same argument holds over the W = d * s ranks, every collective inside the
model being differentiated by its transpose.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..config import compute_dtype
from ..models.layers.convs import DropPath, spatial_shard, sync_batch_norm
from ..ops.losses import deep_supervision_loss
from .optim import get_optimizer, set_lr


class TrainState:
    """The live model, its optimizer, the EMA copy (None without EMA), the
    number of steps taken, and the generator of the model's stochastic
    depth (None when it has none)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 ema: nn.Module | None = None, step: int = 0,
                 generator: torch.Generator | None = None):
        self.model = model
        self.optimizer = optimizer
        self.ema = ema
        self.step = step
        self.generator = generator


def create_train_state(model: nn.Module, cfg, seed: int | None = None,
                       mesh=None) -> TrainState:
    """Optimizer over every parameter, and an EMA copy (eval mode) when
    ``cfg.ema``.  Every stochastic module of the model with a nonzero rate
    (a module with a rate ``p`` and a ``generator`` slot: ``DropPath``,
    ``Dropout``, VNet's ``ChannelDropout``) draws its keep masks from one
    ``torch.Generator`` on the model's device, which the state owns, seeded
    from ``seed`` (default: the run's ``split_seed``, the JAX step's
    dropout seed) as the input pipeline seeds its own; the EMA copy
    evaluates in eval mode and draws none.  With a ``mesh`` the generator
    is seeded ``seed + rank`` (each rank draws its own rows' masks), and
    the live model's BatchNorms take the global batch's statistics.  Under
    a 'spatial' axis the live model is marked for its H slabs
    (``spatial_shard``), and the ``DropPath`` modules, which draw one
    number a sample, take a second generator seeded ``seed + data rank``:
    the spatial peers of a sample keep or drop it alike, while the
    elementwise masks of each slab stay its own."""
    opt = get_optimizer(cfg, model.parameters())
    ema = None
    if cfg.get("ema", False):
        ema = copy.deepcopy(model).requires_grad_(False).eval()
    if mesh is not None:
        sync_batch_norm(model, mesh.group)    # after the copy: see its doc
        if mesh.spatial_size > 1:
            spatial_shard(model, mesh.spatial_group)
    drops = [m for m in model.modules()
             if hasattr(m, "generator") and getattr(m, "p", 0)]
    generator = None
    if drops:
        if seed is None:
            seed = int(cfg.get("split_seed", 0) or 0)
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(
            seed + (mesh.rank if mesh is not None else 0))
        per_sample = generator
        if mesh is not None and mesh.spatial_size > 1:
            per_sample = torch.Generator(device=device).manual_seed(
                seed + mesh.data_rank)
        for m in drops:
            m.generator = per_sample if isinstance(m, DropPath) else generator
    return TrainState(model, opt, ema, generator=generator)


def make_train_step(model: nn.Module, opt: torch.optim.Optimizer, cfg,
                    mesh=None):
    """``train_step(state, img, lab, lr) -> loss`` for img (B, *spatial, C)
    float and lab (B, *spatial) int on the model's device.  The returned
    loss is a detached device scalar: reading it synchronises.  With a
    ``mesh`` img and lab are this rank's rows of the global batch, and the
    loss is the global batch's, the same on every rank."""
    params = list(model.parameters())
    net, group = model, None
    if mesh is not None:
        group = mesh.group
        cuda = params[0].is_cuda
        # static_graph: the set of parameters that take a gradient never
        # changes, so DDP finds the unused ones (DAUNet's heads) in the
        # first step alone, where find_unused_parameters would walk the
        # autograd graph every step; their gradients stay None and are
        # filled below, after the reduction
        net = nn.parallel.DistributedDataParallel(
            model, device_ids=[params[0].device] if cuda else None,
            process_group=group, static_graph=True)
    class_weights = None
    if cfg.get("weight"):
        # on the device once: building it per step would copy (and sync)
        class_weights = torch.tensor(cfg.weight, dtype=torch.float32,
                                     device=params[0].device)
    aux_weight = list(cfg.aux_weight) if cfg.aux_loss else [1.0]
    rlt = float(cfg.rlt)
    ema_alpha = float(cfg.ema_alpha)
    amp = compute_dtype(cfg) == torch.bfloat16

    def train_step(state: TrainState, img, lab, lr) -> torch.Tensor:
        set_lr(opt, lr)
        opt.zero_grad(set_to_none=True)
        x = img.movedim(-1, 1)
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=amp and x.is_cuda):
            out = net(x)
            outs = out if isinstance(out, (list, tuple)) else [out]
            loss = deep_supervision_loss(outs, lab, aux_weight,
                                         class_weights, rlt, group)
        loss.backward()
        # a parameter that no output reads (DAUNet's three unused heads,
        # MedFormer-2D's last semantic-map reductions) has no gradient, and
        # torch's optimizers skip it; the JAX step gives it a zero gradient,
        # so optax decays it (AdamW) or adds its L2 term (Adam): a zero
        # gradient here takes the same update (on every rank alike: no
        # rank's output reads it)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        if state.ema is not None:
            # alpha = min(1 - 1/(step+1), ema_alpha), step before the
            # increment (cbim_tpu train_state.py:107-114)
            alpha = min(1.0 - 1.0 / (state.step + 1), ema_alpha)
            with torch.no_grad():
                ema_params = list(state.ema.parameters())
                torch._foreach_mul_(ema_params, alpha)
                torch._foreach_add_(ema_params, params, alpha=1.0 - alpha)
                # buffers copied (cbim_tpu train_state.py:114)
                for e, b in zip(state.ema.buffers(), model.buffers()):
                    e.copy_(b)
        state.step += 1
        return loss.detach()

    return train_step


def eval_variables(state: TrainState, use_ema: bool) -> nn.Module:
    """The module to evaluate: the EMA copy when enabled (reference
    train.py:101), else the live model."""
    if use_ema and state.ema is not None:
        return state.ema
    return state.model
