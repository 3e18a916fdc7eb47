"""The port's training CLI under ``torchrun`` on the CPU: two gloo ranks
train a tiny synthetic fold (one epoch of two steps, then its evaluation,
the volume sweeps sharded over the two ranks).

``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
cbim_tpu_torch.train --device cpu ...`` must leave what one process would:
one set of checkpoints (rank 0's: the unwrapped model, no DDP ``module.``
prefix) that ``load_weights`` and ``cbim_tpu``'s ``torch_import`` read as
they are, one ``scalars.jsonl`` (the loss of each step once, the
volumes/s per rank), ``config.txt``, the fold log and
``cross_validation.txt``.
"""

import json
import os
import subprocess
import sys

import jax
import pytest
import torch
import yaml

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.training.checkpoint import load_weights
from test_torch_parallel_train import IN3D
from test_torch_swin_unetr import jax_params
from test_torch_threads import TEST_THREADS, few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the fold: tests/test_parallel.py's UNet-3D on five 10 x 24 x 24
#: synthetic cases, two steps of a global batch of 4, evaluation after the
#: epoch by a 8 x 16 x 16 sliding window
FOLD = dict(
    IN3D, synthetic_cases=5, synthetic_shape=[10, 24, 24],
    affine_pad_size=[2, 4, 4], scale=[0.1, 0.2, 0.2], rotate=[10, 0, 0],
    translate=[0, 0, 0], gaussian_noise_std=0.02, iter_per_epoch=2,
    print_freq=1, val_freq=1, sliding_window=True, window_size=[8, 16, 16],
    k_fold=5, split_seed=0)
W, BATCH = 2, 4
#: seconds the launch may take (two interpreters importing torch)
TIMEOUT = 300


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    d = {k: v for k, v in FOLD.items() if k not in ("dataset", "model",
                                                       "dimension")}
    os.makedirs(tmp / "configs" / "synthetic")
    with open(tmp / "configs" / "synthetic" / "unet_3d.yaml", "w") as f:
        yaml.safe_dump(d, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(W), "-m", "cbim_tpu_torch.train",
           "--device", "cpu", "--dataset", "synthetic", "--model", "unet",
           "--dimension", "3d", "--config_root", str(tmp / "configs"),
           "--batch_size", str(BATCH), "--epochs", "1", "--folds", "1",
           "--cp_path", str(tmp / "exp"), "--log_path", str(tmp / "log"),
           "--unique_name", "ddp"]
    env = dict(os.environ, OMP_NUM_THREADS=str(TEST_THREADS),
               PYTHONPATH=REPO)
    run = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-8000:]
    return tmp, run


def test_one_set_of_checkpoints_and_logs(fold):
    tmp, run = fold
    cp = tmp / "exp" / "synthetic" / "ddp"
    assert sorted(os.listdir(cp)) == [
        "config.txt", "cross_validation.txt", "fold_0.txt",
        "fold_0_best.ckpt", "fold_0_latest.ckpt"]
    assert "Dice" in (cp / "cross_validation.txt").read_text()
    assert run.stdout.count("All 1 folds done.") == 1


def test_checkpoint_holds_the_unwrapped_model(fold):
    """No ``module.`` prefix: ``load_weights`` loads it strictly into the
    port's model, and the JAX package's importer maps its state_dict."""
    tmp, _ = fold
    path = tmp / "exp" / "synthetic" / "ddp" / "fold_0_latest.ckpt"
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert payload["epoch"] == 1 and payload["step"] == 2
    assert not any(k.startswith("module.") for k in payload["model"])
    cfg = config_from_dict(FOLD)
    model = get_model(cfg, device="cpu")
    load_weights(str(path), model, prefer_ema=True, cfg=cfg)
    torch.testing.assert_close(model.state_dict(), payload["ema"])
    jm = jax_get_model(jax_config(FOLD))
    params = torch_import.import_for_model(
        jax_config(FOLD), {k: v.numpy() for k, v in payload["model"].items()},
        jax_params(jm, (1, 8, 16, 16, 1), seed=0))
    n = sum(p.size for p in jax.tree_util.tree_leaves(params))
    assert n == sum(p.numel() for p in model.parameters())


def test_scalars_are_written_once(fold):
    """Rank 0's scalars alone: each step's loss once, one volumes/s figure
    per epoch (the global batch over W ranks and the step time), and the
    evaluation's Dice."""
    tmp, _ = fold
    rows = [json.loads(ln) for ln in open(
        tmp / "log" / "synthetic" / "ddp" / "fold_0" / "scalars.jsonl")]
    tags = [r["tag"] for r in rows]
    assert tags.count("Train/StepLoss") == FOLD["iter_per_epoch"]
    per_chip = [r["value"] for r in rows
                if r["tag"] == "Perf/volumes_per_sec_per_chip"]
    assert len(per_chip) == 1 and per_chip[0] > 0
    assert tags.count("Dice/test_AVG") == 1
