"""Training CLI of the port (counterpart of the root ``train.py``).

Usage (the JAX package's flags, with ``--device`` for its ``--platform``):
    python -m cbim_tpu_torch.train --dataset synthetic --model medformer \\
        --dimension 3d --batch_size 2 --unique_name smoke --amp \\
        [--device cuda|cpu]

``--amp`` selects bf16 compute under ``torch.autocast`` on CUDA; on the
CPU the port trains in fp32.

Data parallelism (the JAX package's mesh): launched by ``torchrun``, every
process trains one rank, on ``cuda:LOCAL_RANK`` over NCCL with ``--device
cuda``, on the CPU over gloo with ``--device cpu``:
    torchrun --nproc_per_node N -m cbim_tpu_torch.train ... --batch_size B
``--batch_size`` is the global batch: each rank takes B // N rows of it
(N must divide B), and the loss, its gradient and the BatchNorm statistics
are the global batch's.  A config with ``mesh_axes: [data, spatial]`` and
``mesh_shape: [d, s]`` (N = d * s) shards the crop's H axis over s ranks
instead: each data index takes B // d rows, each of its s ranks an H slab
of them (MedFormer-3D, UNet-3D and ResUNet-3D).  ``--backend gloo`` with
``--device cuda`` keeps the tensors on the card and lets ranks share one
(NCCL refuses that).  Rank 0 alone writes the checkpoints, the scalars,
the fold logs, config.txt and cross_validation.txt.  A launch of one
process, or none, trains without a process group.
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np
import torch
import torch.distributed as dist


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="CBIM-Torch training")
    parser.add_argument("--dataset", type=str, default="acdc")
    parser.add_argument("--model", type=str, default="unet")
    parser.add_argument("--dimension", type=str, default="2d")
    parser.add_argument("--pretrain", action="store_true",
                        help="initialize from --init_model (a .pth)")
    parser.add_argument("--init_model", type=str, default=None)
    parser.add_argument("--amp", action="store_true",
                        help="bf16 compute (torch.autocast on CUDA)")
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--load", type=str, default=False,
                        help="checkpoint to resume from")
    parser.add_argument("--cp_path", type=str, default="./exp/")
    parser.add_argument("--log_path", type=str, default="./log/")
    parser.add_argument("--unique_name", type=str, default="test")
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=None,
                        help="override config epochs")
    parser.add_argument("--folds", type=int, default=None,
                        help="train only the first N folds")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (an sm_90 card; an error without one) "
                             "or 'cpu'")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="the process group's backend under torchrun: "
                             "NCCL on the card and gloo on the CPU by "
                             "default; gloo on the card lets ranks share a "
                             "card")
    return parser


def main(argv=None, cfg=None) -> list:
    """Run the CLI on ``argv`` (default: sys.argv).  ``cfg`` replaces the
    YAML lookup with an already-built config; the flags still override it,
    as they override the YAML.  Returns the per-fold (dice, hd, asd)."""
    args = get_parser().parse_args(argv)

    from .parallel import initialize_distributed

    started = initialize_distributed(device=args.device,
                                     backend=args.backend)
    try:
        return _run(args, cfg)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, cfg) -> list:
    """``main`` after the process group (if any) is up: a mesh when one
    is."""
    from .config import config_from_dict, load_config, save_configure
    from .ops._backend import get_device
    from .parallel import make_mesh
    from .training.trainer import train_net, write_cross_validation
    from .utils.logging import configure_logger

    overrides = dict(
        pretrain=args.pretrain, amp=args.amp, batch_size=args.batch_size,
        resume=args.resume, load=args.load, cp_path=args.cp_path,
        log_path=args.log_path, unique_name=args.unique_name)
    if cfg is None:
        cfg = load_config(args.dataset, args.model, args.dimension,
                          config_root=args.config_root, **overrides)
    else:
        cfg = config_from_dict(dict(cfg.__dict__, compute_dtype="float32"),
                               **overrides)
    if args.epochs is not None:
        cfg.epochs = args.epochs
    if args.init_model is not None:
        cfg.init_model = args.init_model
    if cfg.pretrain and not cfg.get("init_model"):
        logging.warning("--pretrain set but no --init_model/config "
                        "init_model checkpoint given; training from scratch")
    mesh = make_mesh(cfg, device=args.device) if dist.is_initialized() \
        else None
    device = mesh.device if mesh is not None else get_device(args.device)
    lead = mesh is None or mesh.rank == 0
    if cfg.reproduce_seed is not None:
        random.seed(cfg.reproduce_seed)
        np.random.seed(cfg.reproduce_seed)
        torch.manual_seed(cfg.reproduce_seed)

    n_folds = args.folds if args.folds is not None else cfg.k_fold
    results = []
    for fold_idx in range(n_folds):
        cp_dir = os.path.join(cfg.cp_path, cfg.dataset, cfg.unique_name)
        if lead:
            os.makedirs(cp_dir, exist_ok=True)
            configure_logger(os.path.join(cp_dir, f"fold_{fold_idx}.txt"))
            save_configure(cfg, cp_dir)
        else:
            configure_logger(None)
            logging.getLogger().setLevel(logging.WARNING)
        logging.info("\nDataset: %s,\nModel: %s,\nDimension: %s",
                     cfg.dataset, cfg.model, cfg.dimension)
        results.append(train_net(cfg, fold_idx, device=device, mesh=mesh))
        logging.info("Training on Fold %d is done", fold_idx)

    if lead:
        write_cross_validation(cfg, *zip(*results))
        print(f"All {n_folds} folds done.")
    return results


if __name__ == "__main__":
    main()
