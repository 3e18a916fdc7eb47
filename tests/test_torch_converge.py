"""The convergence tool (``cbim_tpu_torch.tools.converge``) on the CPU: its
recipe is ``configs/synthetic/medformer_3d.yaml``, the YAML it writes for
the JAX package's CLI loads back as that recipe, and a tiny run reports
the Dice trajectory that the trainer logged."""

import json
import os

import pytest

from cbim_tpu.config import load_config as jax_load_config
from cbim_tpu_torch.tools import converge
from test_torch_validation import TRAIN3D
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_recipe_is_the_synthetic_yaml():
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(REPO, "configs", "synthetic",
                           "medformer_3d.yaml")) as f:
        want = yaml.safe_load(f)
    got = {k: v for k, v in converge.RECIPE.items()
           if k not in ("dataset", "model", "dimension")}
    assert got == want


def test_written_config_loads_in_the_jax_package(tmp_path):
    pytest.importorskip("yaml")
    assert converge.main(["--write_config", str(tmp_path), "--seeds", "1",
                          "--epochs", "4", "--iter_per_epoch", "3",
                          "--val_freq", "2"]) == 0
    cfg = jax_load_config("synthetic", "medformer", "3d",
                          config_root=str(tmp_path))
    want = converge.recipe(1, 4, 3, 2)
    assert {k: getattr(cfg, k) for k in want} == want


def test_tiny_run_reports_the_logged_trajectory(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr(converge, "RECIPE", dict(TRAIN3D, print_freq=10))
    monkeypatch.setattr(converge, "BATCH", 1)
    out = str(tmp_path / "runs")
    assert converge.main(["--seeds", "0", "--epochs", "2",
                          "--iter_per_epoch", "1", "--val_freq", "1",
                          "--device", "cpu", "--out", out]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run = result["runs"]["0"]
    assert [e for e, _ in run["trajectory"]] == [1, 2]
    assert len(run["final_dice"]) == 2
    assert result["final_mean_dice"] == run["trajectory"][-1][1]
    log_dir = os.path.join(out, "log", "synthetic", "converge_seed0",
                           "fold_0")
    assert converge.main(["--read", log_dir]) == 0
    line = capsys.readouterr().out.strip()
    assert json.loads(line.split(" ", 1)[1]) == run["trajectory"]
