"""The training runtime (counterpart of ``cbim_tpu/training/trainer.py``;
reference train.py:51-135 train_net / train_epoch).

One fold: dataset, input pipeline, model, optimizer; the epoch loop with
the per-epoch LR, the train step, the next batch prepared while the step
runs, a loss fetch every ``print_freq`` steps, the volumes/s meter, and the
latest checkpoint.  A 3D epoch is ``iter_per_epoch`` steps, a 2D epoch the
slice count // batch.  With ``cfg.profile_dir`` the first epoch's steps
after its first two (first use of every kernel, cuDNN's algorithm search)
are traced (``utils.profiling``).  Every ``val_freq`` epochs the EMA model
(the live one without EMA) is evaluated on the fold's test split
(``validation.validate``: Dice, ASD, HD95), the scalars logged, and the best
evaluation by mean Dice kept, with its checkpoint.

Data parallelism (``mesh``, ``parallel.make_mesh``): every rank runs this
loop on ``cfg.batch_size // W`` rows of the global batch (W must divide it,
as on the JAX mesh), with the global batch's loss, gradient and BatchNorm
statistics (``train_state``); an epoch has as many steps as one process
would take, and ``Perf/volumes_per_sec_per_chip`` divides by W, as JAX
divides by its device count.  Rank 0 alone writes the checkpoints (the
unwrapped model's state_dict) and the scalars, each save followed by a
barrier; every rank evaluates (``validate`` with the mesh: the same
result on every rank, so they keep the same best) and resumes from the
same checkpoint.

Under a 'spatial' mesh axis of s > 1 (``mesh_axes: [data, spatial]``) the
W = d * s ranks step on ``cfg.batch_size // d`` rows each, each of the s
peers of a data index on its H slab (``parallel.spatial``): the one-process
step's loss, gradient and statistics, as the JAX mesh's H-sharded step.
Evaluation is unchanged: the peers take part as sweep ranks.  The
models: :data:`SPATIAL_MODELS`, the CNNs and MedFormer in 3D and 2D.
Refused before any step: the attention models (:data:`ATTENTION_MODELS`,
ROADMAP A7d, named), an H that the axis does not divide, a slab that the
product of the model's H down-scales does not divide (every level's slab
must stay whole; JAX's partitioner reshards unevenly instead, ROADMAP
A7e), and a deepest slab thinner than the model's halo (VNet's 5^3
convs: 2 rows) (:func:`h_layout`).
"""

from __future__ import annotations

import logging
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.factory import get_dataset
from ..data.pipeline import TrainPipeline
from ..inference.engines import make_engine
from ..models import _norm_scales, get_model
from ..ops._backend import get_device
from ..utils.logging import (AverageMeter, MetricWriter, ProgressMeter,
                             log_evaluation_result)
from ..utils.profiling import StepProfiler
from .checkpoint import load_checkpoint, save_checkpoint
from .pretrained import load_init_model
from .schedules import exp_lr_scheduler_with_warmup
from .train_state import create_train_state, eval_variables, make_train_step
from .validation import filter_validation_results, validate


def load_pretrained(cfg, state) -> None:
    """Initialise the model (and its EMA copy) from ``cfg.init_model``
    through ``pretrained.load_init_model``: a backbone file the model
    takes (SwinUNETR's self-supervised swin-vit, SwinUnet's swin-tiny)
    sets that part, anything else goes through ``checkpoint.load_weights``,
    the prediction CLI's loader (a port ``.ckpt``, a reference wrapper or a
    JAX package's Flax ``.ckpt`` gives its EMA weights, the eval convention
    of ``cbim_tpu``'s torch import; a ``.pth`` state_dict itself)."""
    load_init_model(str(cfg.init_model), state.model, cfg)
    if state.ema is not None:
        state.ema.load_state_dict(state.model.state_dict())


#: the models that train on H slabs (ROADMAP A7, A7b, A7c)
SPATIAL_MODELS = (("3d", "medformer"), ("3d", "unet"), ("3d", "resunet"),
                  ("3d", "unet++"), ("3d", "attention_unet"), ("3d", "vnet"),
                  ("2d", "unet"), ("2d", "resunet"), ("2d", "unet++"),
                  ("2d", "attention_unet"), ("2d", "medformer"))
#: the models whose attention spans every token or position of the volume
#: (windows, patch embeddings, a ViT, DAUNet's position attention): they
#: need attention across slabs, ROADMAP A7d
ATTENTION_MODELS = ("unetr", "swin_unetr", "vtunet", "nnformer", "swinunet",
                    "daunet", "transunet")


def h_layout(cfg) -> tuple[int, int, int]:
    """(H of the crop, the product of the model's H down-scales, the rows
    of H a slab needs at the deepest level): H is ``training_size[1]`` of
    a 3D crop and ``[0]`` of a 2D one, as the JAX trainer reads it; the
    down-scales are the config's for the 3D UNet family and MedFormer-3D,
    four of 2 for VNet and the 2D models (their pools and merges, whatever
    the config says); VNet's 5^3 convs take a halo of 2 rows, the others'
    3-row kernels 1."""
    h = int(cfg.training_size[1 if cfg.dimension == "3d" else 0])
    if cfg.dimension == "2d" or cfg.model == "vnet":
        return h, 16, 2 if cfg.model == "vnet" else 1
    return h, math.prod(sc[1] for sc in _norm_scales(cfg.down_scale, 4)), 1


def check_spatial(cfg, s: int) -> None:
    """Refuse what H-sharded training over ``s`` slabs does not carry
    (module docstring)."""
    key = (cfg.dimension, cfg.model)
    if key not in SPATIAL_MODELS:
        item = ("A7d (attention across slabs)" if cfg.model
                in ATTENTION_MODELS else "A7 (not a model of the port)")
        raise NotImplementedError(
            f"model {cfg.model!r} ({cfg.dimension}) on a 'spatial' mesh axis "
            f"of {s}: H-sharded training covers "
            f"{', '.join(f'{m} ({d})' for d, m in SPATIAL_MODELS)}; this one "
            f"is ROADMAP {item}")
    h, down, rows = h_layout(cfg)
    if h % (s * down):
        raise ValueError(
            f"training_size's H {h} does not divide into {s} slabs whose "
            f"rows divide by the product of the model's H down-scales, "
            f"{down}: every level's slab must be whole (ROADMAP A7e)")
    if h // (s * down) < rows:
        raise ValueError(
            f"model {cfg.model!r}: its 5^3 convs take a halo of {rows} rows, "
            f"but at its deepest level (H / {down}) a slab of training_size's "
            f"H {h} over {s} slabs has {h // (s * down)}: every level's slab "
            f"needs at least {rows} rows (H of at least {rows * s * down})")


class _NoWriter:
    """The scalar sink of a rank other than 0: writes nothing."""

    def add_scalar(self, tag, value, step):
        pass

    def close(self):
        pass


def train_net(cfg, fold_idx: int = 0, device="cuda", mesh=None):
    """Train one fold on ``device`` (the card unless the caller asks for the
    CPU); returns (best_dice, best_hd, best_asd): the arrays of the best
    evaluation, or the initial zeros and 1000s when none ran or every one
    was NaN (an empty test split).  ``mesh``: this rank's place in a
    data-parallel run (module docstring)."""
    device = get_device(device)
    W = mesh.size if mesh is not None else 1
    d = mesh.data_size if mesh is not None else 1
    if cfg.batch_size % d:
        raise ValueError(f"batch_size {cfg.batch_size} does not divide over "
                         f"{d} data ranks")
    if mesh is not None and mesh.spatial_size > 1:
        check_spatial(cfg, mesh.spatial_size)
    lead = mesh is None or mesh.rank == 0
    trainset = get_dataset(cfg, mode="train", fold_idx=fold_idx)
    testset = get_dataset(cfg, mode="test", fold_idx=fold_idx)
    pipeline = TrainPipeline(trainset, cfg, seed=cfg.split_seed + fold_idx,
                             device=device, mesh=mesh)
    logging.info("Created Dataset and Pipeline")

    model = get_model(cfg, device=device, train=True,
                      generator=torch.Generator().manual_seed(
                          cfg.split_seed + 1000 * fold_idx))
    state = create_train_state(model, cfg,
                               seed=cfg.split_seed + fold_idx, mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    logging.info("Created Model (%s, %.2fM params)", cfg.model, n_params / 1e6)

    ckpt_dir = os.path.join(cfg.cp_path, cfg.dataset, cfg.unique_name)
    writer = _NoWriter()
    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)
        writer = MetricWriter(os.path.join(cfg.log_path, cfg.dataset,
                                           cfg.unique_name,
                                           f"fold_{fold_idx}"))

    def save(name: str, epoch: int) -> None:
        if lead:
            save_checkpoint(os.path.join(ckpt_dir, name), state, epoch)
        if mesh is not None:
            dist.barrier(group=mesh.group)

    start_epoch = cfg.start_epoch
    if cfg.resume and cfg.load:
        state, start_epoch = load_checkpoint(cfg.load, state)
        logging.info("Resumed from %s at epoch %d", cfg.load, start_epoch)
    elif cfg.pretrain and cfg.get("init_model"):
        load_pretrained(cfg, state)
        logging.info("Initialized from checkpoint %s", cfg.init_model)
    # after the weights are set: DDP takes rank 0's as it wraps the model
    train_step = make_train_step(model, state.optimizer, cfg, mesh)

    if cfg.dimension == "2d":
        # an epoch is the reference DataLoader's: slice count // batch
        # (the pipeline draws each epoch's slices without replacement)
        iters = max(1, len(trainset.images) // cfg.batch_size)
    else:
        iters = cfg.iter_per_epoch
    best_dice = np.zeros(cfg.classes)
    best_hd = np.ones(cfg.classes) * 1000
    best_asd = np.ones(cfg.classes) * 1000
    # the reference's scalar rule (train.py:87,117): the initial best is
    # mean(zeros) = 0, and >= makes the first evaluation win
    best_mean = 0.0
    # one engine for the fold: the module it wraps (the EMA copy) is
    # updated in place by every step
    eval_model = eval_variables(state, cfg.ema)
    eval_engine = make_engine(eval_model, cfg)

    for epoch in range(start_epoch, cfg.epochs):
        lr = exp_lr_scheduler_with_warmup(cfg.base_lr, epoch, warmup_epoch=5,
                                          max_epoch=cfg.epochs)
        logging.info("Starting epoch %d/%d (lr %.4e)", epoch + 1, cfg.epochs, lr)
        batch_time = AverageMeter("Time", ":6.2f")
        epoch_loss = AverageMeter("Loss", ":.2f")
        progress = ProgressMeter(iters, [batch_time, epoch_loss],
                                 prefix=f"Epoch: [{epoch + 1}]")

        profiler = None
        if cfg.get("profile_dir") and epoch == start_epoch and lead:
            profiler = StepProfiler(cfg.profile_dir, device)
        tic = time.time()
        img, lab = pipeline.next_batch(cfg.batch_size)
        first_traced = min(2, iters - 1)
        for it in range(iters):
            if profiler is not None and it == first_traced:
                profiler.start()
            loss = train_step(state, img, lab, lr)
            if it + 1 < iters:
                # the next batch's host work and copy overlap the queued step
                img, lab = pipeline.next_batch(cfg.batch_size)
            if it % cfg.print_freq == 0:
                # the loss fetch synchronises; pay it only when printing
                loss_value = float(loss)
                seconds = time.time() - tic
                epoch_loss.update(loss_value, cfg.batch_size)
                batch_time.update(seconds)
                progress.display(it)
                writer.add_scalar("Train/StepLoss", loss_value, state.step)
                writer.add_scalar("Perf/StepSeconds", seconds, state.step)
            tic = time.time()
        if profiler is not None:
            summary = profiler.stop(steps=iters - first_traced)
            logging.info("Profiled %d steps: %.3f s wall, device busy %.1f %%; "
                         "written to %s", summary["steps"],
                         summary["wall_seconds"],
                         100 * summary["device_busy_share"], cfg.profile_dir)

        if batch_time.count:
            writer.add_scalar("Perf/volumes_per_sec_per_chip",
                              cfg.batch_size / W / max(batch_time.avg, 1e-9),
                              epoch + 1)
        writer.add_scalar("Train/Loss", epoch_loss.avg, epoch + 1)
        writer.add_scalar("LR", lr, epoch + 1)
        save_ckpt = cfg.get("save_ckpt", True)
        if save_ckpt:
            save(f"fold_{fold_idx}_latest.ckpt", epoch + 1)

        if (epoch + 1) % cfg.val_freq == 0:
            dice, asd, hd = validate(eval_model, testset, cfg,
                                     engine=eval_engine, mesh=mesh)
            dice, asd, hd = filter_validation_results(dice, asd, hd, cfg)
            log_evaluation_result(writer, dice, asd, hd, "test", epoch)
            if np.nanmean(dice) >= best_mean:
                best_mean = float(np.nanmean(dice))
                best_dice, best_hd, best_asd = dice, hd, asd
                if save_ckpt:
                    save(f"fold_{fold_idx}_best.ckpt", epoch + 1)
            logging.info("Evaluation Done")
            logging.info("Dice: %.4f / Best Dice: %.4f", np.nanmean(dice),
                         best_mean)

    writer.close()
    return best_dice, best_hd, best_asd


def write_cross_validation(cfg, dice_list, hd_list, asd_list):
    """cross_validation.txt aggregation (reference train.py:347-383)."""
    total_dice = np.vstack(dice_list)
    total_hd = np.vstack(hd_list)
    total_asd = np.vstack(asd_list)
    out_dir = os.path.join(cfg.cp_path, cfg.dataset, cfg.unique_name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cross_validation.txt"), "w") as f:
        np.set_printoptions(precision=4, suppress=True)
        for name, per_fold, total in [("Dice", dice_list, total_dice),
                                      ("HD", hd_list, total_hd),
                                      ("ASD", asd_list, total_asd)]:
            f.write(f"{name}\n")
            for i, row in enumerate(per_fold):
                f.write(f"Fold {i}: {row}\n")
            f.write(f"Each Class {name} Avg: {np.mean(total, axis=0)}\n")
            f.write(f"Each Class {name} Std: {np.std(total, axis=0)}\n")
            f.write(f"All classes {name} Avg: {total.mean()}\n")
            f.write(f"All classes {name} Std: {np.mean(total, axis=1).std()}\n")
            f.write("\n")
