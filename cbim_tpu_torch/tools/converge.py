"""Convergence check of the port: train the synthetic MedFormer-3D recipe
and print the validation Dice at every ``val_freq``.

The recipe is ``configs/synthetic/medformer_3d.yaml`` (held here as
``RECIPE``: the card's machine has no YAML parser;
``tests/test_torch_converge.py`` holds the two equal), with its epochs,
steps per epoch and evaluation interval set by the flags.  Each seed trains
one fold through ``cbim_tpu_torch.train.main`` at batch 2 in fp32; the seed
is the config's ``split_seed``, which seeds the split, the weights and the
batch draws in both packages.

    python -m cbim_tpu_torch.tools.converge [--seeds 0,1] [--epochs 10] \\
        [--iter_per_epoch 2] [--val_freq 2] [--device cuda] [--out DIR]

prints, per seed, each evaluation's epoch and mean foreground Dice
(``Dice/test_AVG``), then one JSON line with the trajectories and the mean
over the seeds of the final Dice.

The JAX package trains the same recipe with its own CLI:

    python -m cbim_tpu_torch.tools.converge --write_config DIR --seeds 0 ...
    python train.py --dataset synthetic --model medformer --dimension 3d \\
        --batch_size 2 --folds 1 --platform cpu --config_root DIR ...
    python -m cbim_tpu_torch.tools.converge --read LOG_DIR [LOG_DIR ...]

``--write_config`` writes the recipe (one seed) as
``DIR/synthetic/medformer_3d.yaml``; ``--read`` prints the trajectory of
any run's ``scalars.jsonl`` directory (``<log_path>/synthetic/<name>/
fold_0``), the port's or the JAX package's: both write the same scalars.
"""

from __future__ import annotations

import argparse
import json
import os
import time

#: configs/synthetic/medformer_3d.yaml
RECIPE = dict(
    dataset="synthetic", model="medformer", dimension="3d",
    data_root="/nonexistent", classes=3, modality="synthetic",
    arch="medformer", in_chan=1, base_chan=32, conv_block="BasicBlock",
    down_scale=[[1, 2, 2], [1, 2, 2], [2, 2, 2], [2, 2, 2]],
    kernel_size=[[1, 3, 3], [1, 3, 3], [3, 3, 3], [3, 3, 3], [3, 3, 3]],
    norm="in", act="gelu", map_size=[2, 4, 4],
    conv_num=[2, 0, 0, 0, 0, 0, 2, 2], trans_num=[0, 2, 2, 2, 2, 2, 0, 0],
    num_heads=[1, 4, 4, 4, 4, 4, 1, 1], expansion=4, fusion_depth=2,
    fusion_dim=256, fusion_heads=4, attn_drop=0.0, proj_drop=0.0,
    proj_type="depthwise", epochs=20, training_size=[16, 64, 64],
    synthetic_cases=6, synthetic_shape=[24, 96, 96], start_epoch=0,
    aux_loss=True, aux_weight=[0.5, 0.5], split_seed=0, k_fold=6,
    optimizer="adamw", base_lr=0.001, betas=[0.9, 0.999], weight_decay=0.05,
    weight=[0.5, 1, 1], rlt=1, scale=[0.1, 0.2, 0.2], rotate=[20, 0, 0],
    translate=[0, 0, 0], affine_pad_size=[4, 16, 16],
    gaussian_noise_std=0.02, additive_brightness_std=0.5,
    gamma_range=[0.7, 1.4], print_freq=10, iter_per_epoch=25, ema=True,
    ema_alpha=0.99, val_freq=5, sliding_window=True,
    window_size=[16, 64, 64], mesh_axes=["data"], mesh_shape=None,
    remat=True, reproduce_seed=2023)
BATCH = 2


def recipe(seed: int, epochs: int, iter_per_epoch: int, val_freq: int
           ) -> dict:
    return dict(RECIPE, split_seed=seed, epochs=epochs,
                iter_per_epoch=iter_per_epoch, val_freq=val_freq)


def trajectory(log_dir: str) -> list[tuple[int, float]]:
    """(epoch, mean foreground Dice) of every evaluation logged in
    ``log_dir/scalars.jsonl``."""
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows
            if r["tag"] == "Dice/test_AVG"]


def train_seed(seed: int, args) -> dict:
    """Train one seed's fold through the training CLI; its trajectory,
    final per-class Dice and wall seconds."""
    from .. import train
    from ..config import config_from_dict
    name = f"converge_seed{seed}"
    cfg = config_from_dict(recipe(seed, args.epochs, args.iter_per_epoch,
                                  args.val_freq))
    argv = ["--dataset", "synthetic", "--model", "medformer", "--dimension",
            "3d", "--batch_size", str(BATCH), "--folds", "1",
            "--cp_path", os.path.join(args.out, "exp"),
            "--log_path", os.path.join(args.out, "log"),
            "--unique_name", name, "--device", args.device]
    t0 = time.perf_counter()
    (dice, _, _), = train.main(argv, cfg=cfg)
    seconds = time.perf_counter() - t0
    traj = trajectory(os.path.join(args.out, "log", "synthetic", name,
                                   "fold_0"))
    return {"trajectory": traj, "final_dice": [float(v) for v in dice],
            "seconds": seconds}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", default="0,1",
                        help="comma-separated split seeds")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--iter_per_epoch", type=int, default=2)
    parser.add_argument("--val_freq", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=os.path.join("build", "converge"),
                        help="the runs' checkpoint and log directories")
    parser.add_argument("--write_config", metavar="DIR", default=None,
                        help="write the recipe of the first seed as "
                             "DIR/synthetic/medformer_3d.yaml and stop")
    parser.add_argument("--read", nargs="+", metavar="LOG_DIR",
                        help="print the Dice trajectories of these runs' "
                             "scalars.jsonl directories and stop")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]

    if args.write_config:
        path = os.path.join(args.write_config, "synthetic",
                            "medformer_3d.yaml")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:          # JSON is YAML
            json.dump(recipe(seeds[0], args.epochs, args.iter_per_epoch,
                             args.val_freq), f, indent=1)
        print(path)
        return 0
    if args.read:
        for log_dir in args.read:
            print(log_dir, json.dumps(trajectory(log_dir)))
        return 0

    import torch
    device = torch.device(args.device)
    runs = {}
    for seed in seeds:
        runs[seed] = run = train_seed(seed, args)
        for epoch, dice in run["trajectory"]:
            print(f"seed {seed} epoch {epoch:3d} Dice/test_AVG {dice:.4f}")
        print(f"seed {seed}: {run['seconds']:.1f} s, final per-class Dice "
              f"{run['final_dice']}", flush=True)
    finals = [run["trajectory"][-1][1] for run in runs.values()]
    result = {"recipe": "configs/synthetic/medformer_3d.yaml",
              "epochs": args.epochs, "iter_per_epoch": args.iter_per_epoch,
              "val_freq": args.val_freq, "batch": BATCH,
              "device": str(device), "runs": runs,
              "final_mean_dice": sum(finals) / len(finals)}
    if device.type == "cuda":
        from . import card_line
        result["card"] = card_line()
        print(result["card"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
