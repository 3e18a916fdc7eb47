"""The port's validation (``cbim_tpu_torch.training.validation``) and the
trainer's evaluation epochs vs ``cbim_tpu``'s, on the CPU.

``dice_from_confusion`` and ``filter_validation_results`` must be equal
exactly; ``test_item`` equal on the synthetic test splits (2D with its
centre crop).  ``validate`` runs a tiny MedFormer-3D (sliding window) and a
tiny MedFormer-2D (slice batch, whole image and window) with the same
weights in both packages, fp32 on the CPU: the label maps agree on at least
99.99 % of voxels, Dice within 1e-4, ASD/HD95 within 1e-3 relative (equal
where the maps are equal).  Then ``train_net``: evaluation epochs write the
Dice scalars and the best checkpoint, the best rule (``>=`` on the mean
Dice, starting from 0, NaN never winning) picks the same evaluation as the
JAX trainer's, an empty test split leaves the initial arrays, and the
training CLI writes ``cross_validation.txt`` from the best arrays.
"""

import json

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.data.datasets import Synthetic2D as JaxSynthetic2D
from cbim_tpu.data.datasets import Synthetic3D as JaxSynthetic3D
from cbim_tpu.training import trainer as jax_trainer
from cbim_tpu.training import validation as jax_validation
from cbim_tpu_torch import train as train_cli
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.datasets import Synthetic2D, Synthetic3D
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.training import trainer, validation
from cbim_tpu_torch.utils.jax_import import (medformer2d_state_dict_from_jax,
                                             medformer3d_state_dict_from_jax)
from test_torch_medformer import TINY, jax_medformer, jax_params
from test_torch_medformer2d import TINY2D, jax_variables
from test_torch_threads import few_torch_threads  # noqa: F401

#: the least share of voxels labelled alike by the two packages: fp32
#: forwards that differ in summation order flip only near-tied voxels
LABEL_AGREEMENT = 0.9999
DICE_ATOL = 1e-4
DISTANCE_RTOL = 1e-3

#: the tiny MedFormer-3D of test_torch_inference's sliding-window parity
#: test on a Synthetic3D split with one 40 x 36 x 44 test volume (a 32^3
#: window: clamped edges and repeated starts)
VAL3D = dict(TINY, act="relu", training_size=[32, 32, 32],
             window_size=[32, 32, 32], sliding_window=True,
             synthetic_cases=3, synthetic_shape=[40, 36, 44], k_fold=3,
             split_seed=0)
#: the tiny MedFormer-2D on a Synthetic2D split with two 6 x 40 x 40 test
#: volumes, centre-cropped to 32^2
VAL2D = dict(TINY2D, training_size=[32, 32], synthetic_cases=4, k_fold=2,
             split_seed=1)


def test_dice_from_confusion_equals_jax():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 5, size=(7, 9, 11))
    target = rng.integers(0, 5, size=(7, 9, 11))
    pred[pred == 3] = 0                  # a class never predicted
    target[target == 4] = 1              # one never present
    np.testing.assert_array_equal(
        validation.dice_from_confusion(pred, target, 5),
        jax_validation.dice_from_confusion(pred, target, 5))


@pytest.mark.parametrize("dataset", ["amos_mr", "synthetic"])
def test_filter_validation_results_equals_jax(dataset):
    arrays = [np.arange(6.0) + k for k in range(3)]
    got = validation.filter_validation_results(
        *arrays, config_from_dict(dict(dataset=dataset)))
    ref = jax_validation.filter_validation_results(
        *arrays, jax_config(dict(dataset=dataset)))
    assert len(got[0]) == (4 if dataset == "amos_mr" else 6)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_test_item_equals_jax(dim):
    d = dict(VAL3D, synthetic_cases=4) if dim == "3d" else VAL2D
    mine = (Synthetic3D if dim == "3d" else Synthetic2D)(
        config_from_dict(d), mode="test", k_fold=2, k=0, seed=d["split_seed"])
    ref = (JaxSynthetic3D if dim == "3d" else JaxSynthetic2D)(
        jax_config(d), mode="test", k_fold=2, k=0, seed=d["split_seed"])
    assert len(mine) == len(ref) == 2
    for i in range(2):
        got, want = mine.test_item(i), ref.test_item(i)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        if dim == "2d":       # 6 x 40 x 40 cropped to the 32^2 training size
            assert got[0].shape == (6, 32, 32)
            np.testing.assert_array_equal(got[1],
                                          mine.labels[i][:, 4:36, 4:36])


def _recording(module, monkeypatch):
    """Record the label maps that ``module.validate`` hands to its
    ``calculate_distance``."""
    maps = []
    calculate = module.calculate_distance

    def recorded(pred, lab, spacing, num_classes):
        maps.append(np.asarray(pred))
        return calculate(pred, lab, spacing, num_classes)

    monkeypatch.setattr(module, "calculate_distance", recorded)
    return maps


def _check_validate(monkeypatch, cfg_d, jax_model, jax_vars, model, jax_set,
                    port_set):
    maps = _recording(validation, monkeypatch)
    jax_maps = _recording(jax_validation, monkeypatch)
    got = validation.validate(model, port_set, config_from_dict(cfg_d))
    ref = jax_validation.validate(jax_model, jax_vars, jax_set,
                                  jax_config(cfg_d))
    assert len(maps) == len(jax_maps) == len(port_set)
    same = total = 0
    for i, (a, b) in enumerate(zip(maps, jax_maps)):
        assert a.shape == b.shape == port_set.test_item(i)[0].shape
        assert a.dtype == np.uint8
        same += int(np.count_nonzero(a == b))
        total += a.size
    agree = same / total
    assert agree >= LABEL_AGREEMENT, agree
    n = cfg_d["classes"] - 1
    for g, r in zip(got, ref):
        assert g.shape == (n,)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
    dice, asd, hd = got
    np.testing.assert_allclose(dice, ref[0], atol=DICE_ATOL)
    rtol = 0.0 if agree == 1.0 else DISTANCE_RTOL
    np.testing.assert_allclose(asd, ref[1], rtol=rtol)
    np.testing.assert_allclose(hd, ref[2], rtol=rtol)
    # the random model labels every class somewhere: the distances are
    # measured, not the 500 of an empty mask
    assert np.isfinite(dice).all() and (dice > 0).all()
    assert (asd < 500).all() and (hd < 500).all()


def test_validate_3d_sliding_window_matches_jax(monkeypatch):
    jm = jax_medformer(VAL3D)
    params = jax_params(jm, (1, 32, 32, 32, 1), seed=4)
    cfg = config_from_dict(VAL3D)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(medformer3d_state_dict_from_jax(params, cfg))
    jax_set = JaxSynthetic3D(jax_config(VAL3D), mode="test", k_fold=3)
    port_set = Synthetic3D(cfg, mode="test", k_fold=3)
    _check_validate(monkeypatch, VAL3D, jm, {"params": params}, model,
                    jax_set, port_set)


@pytest.mark.parametrize("window", [False, True])
def test_validate_2d_slice_batch_matches_jax(monkeypatch, window):
    d = dict(VAL2D, sliding_window=window,
             window_size=[32, 32] if window else None)
    jm, v = jax_variables(d, seed=5)
    cfg = config_from_dict(d)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(medformer2d_state_dict_from_jax(v, cfg))
    jax_set = JaxSynthetic2D(jax_config(d), mode="test", k_fold=2,
                             seed=d["split_seed"])
    port_set = Synthetic2D(cfg, mode="test", k_fold=2, seed=d["split_seed"])
    _check_validate(monkeypatch, d, jm, v, model, jax_set, port_set)


def test_validate_evaluates_in_eval_mode_and_restores_the_mode():
    """A train-mode model (no EMA) is evaluated as in eval mode, and is in
    train mode again afterwards."""
    cfg = config_from_dict(dict(VAL2D, synthetic_cases=2))
    model = get_model(cfg, device="cpu", train=True,
                      generator=torch.Generator().manual_seed(0))
    testset = Synthetic2D(cfg, mode="test", k_fold=2)
    modes = []
    model.register_forward_pre_hook(lambda m, a: modes.append(m.training))
    train_mode = validation.validate(model, testset, cfg)
    assert model.training and modes and not any(modes)
    model.eval()
    for g, r in zip(train_mode, validation.validate(model, testset, cfg)):
        np.testing.assert_array_equal(g, r)


# ------------------------------------------------------------- the trainer

#: a 3D recipe on a narrower MedFormer-3D than VAL3D's, 16^3 crops and
#: windows on 16^3 volumes (one window: VAL3D holds the sweep), no remat;
#: 3 cases under k_fold 3: two training volumes, one test volume
TRAIN3D = dict(
    dataset="synthetic", model="medformer", dimension="3d", classes=3,
    base_chan=4, chan_num=[8, 8, 16, 16, 16, 8, 8, 4], map_size=[1, 1, 1],
    conv_block="BasicBlock", conv_num=[1, 0, 0, 0, 0, 0, 1, 1],
    trans_num=[0, 1, 1, 1, 1, 1, 0, 0], num_heads=[1, 2, 2, 2, 2, 2, 1, 1],
    fusion_depth=1, fusion_dim=16, fusion_heads=2, expansion=2,
    proj_type="depthwise", norm="in", act="gelu",
    kernel_size=[[3, 3, 3]] * 5, down_scale=[[2, 2, 2]] * 4, aux_loss=True,
    aux_weight=[0.5, 0.5], weight=[0.5, 1.0, 1.0], optimizer="adamw",
    base_lr=1e-3, weight_decay=0.05, ema=True, ema_alpha=0.99,
    training_size=[16] * 3, window_size=[16] * 3, sliding_window=True,
    synthetic_cases=3, synthetic_shape=[16] * 3, k_fold=3, split_seed=0,
    affine_pad_size=[4] * 3, scale=[0.3] * 3, rotate=[30] * 3,
    translate=[0] * 3, gaussian_noise_std=0.02, batch_size=1,
    iter_per_epoch=1, print_freq=1, val_freq=1, epochs=2, remat=False)


def _paths(tmp_path, **kw):
    return dict(cp_path=str(tmp_path / "exp"), log_path=str(tmp_path / "log"),
                unique_name="v", **kw)


def _scalars(tmp_path):
    return [json.loads(ln) for ln in
            (tmp_path / "log" / "synthetic" / "v" / "fold_0" /
             "scalars.jsonl").read_text().splitlines()]


def test_train_cli_validates_and_keeps_the_best_checkpoint(tmp_path):
    """``python -m cbim_tpu_torch.train`` with its epochs at val_freq:
    each epoch ends in an evaluation, the best one is checkpointed and
    returned, and ``cross_validation.txt`` holds its finite arrays in the
    JAX package's layout."""
    cfg = config_from_dict(TRAIN3D)
    (dice, hd, asd), = train_cli.main(
        ["--dataset", "synthetic", "--model", "medformer", "--dimension",
         "3d", "--batch_size", "1", "--epochs", "2", "--folds", "1",
         "--device", "cpu", "--cp_path", str(tmp_path / "exp"),
         "--log_path", str(tmp_path / "log"), "--unique_name", "v"],
        cfg=cfg)
    for a in (dice, hd, asd):
        assert a.shape == (2,) and np.isfinite(a).all()
    assert (hd <= 500).all() and (asd <= 500).all()
    run = tmp_path / "exp" / "synthetic" / "v"
    best = torch.load(str(run / "fold_0_best.ckpt"), weights_only=True)
    assert best["epoch"] in (1, 2) and best["ema"] is not None
    rows = _scalars(tmp_path)
    avg = [r for r in rows if r["tag"] == "Dice/test_AVG"]
    assert [r["step"] for r in avg] == [1, 2]
    tags = {r["tag"] for r in rows}
    assert {"Dice/test_Dice1", "Dice/test_Dice2", "ASD/test_AVG",
            "ASD/test_ASD2", "HD/test_AVG", "HD/test_HD1"} <= tags
    # the returned arrays are the logged evaluation of the best epoch
    by_step = {r["step"]: r["value"] for r in avg}
    assert by_step[best["epoch"]] == pytest.approx(float(dice.mean()))
    # the JAX package's writer gives the same file for the same arrays
    jcfg = jax_config(dict(TRAIN3D, cp_path=str(tmp_path / "jax"),
                           unique_name="v"))
    jax_trainer.write_cross_validation(jcfg, [dice], [hd], [asd])
    text = (run / "cross_validation.txt").read_text()
    assert text == (tmp_path / "jax" / "synthetic" / "v" /
                    "cross_validation.txt").read_text()
    assert text.startswith("Dice\nFold 0: [") and "\nHD\n" in text
    assert "1000" not in text and "nan" not in text


def _fake_dice(means, k):
    """Evaluation k's Dice: mean means[k] (exactly, in binary fractions),
    entries distinct from every other evaluation's."""
    return np.array([means[k] - 0.125 * (k + 1), means[k] + 0.125 * (k + 1)])


def _fake_validate(means, log):
    """A validate that returns, call by call, Dice arrays of the given
    means (distinct ASD/HD too), and records its calls."""
    def fake(*args, **kwargs):
        k = len(log)
        log.append(k)
        return (_fake_dice(means, k), np.array([10.0 + k, 20.0 + k]),
                np.array([30.0 + k, 40.0 + k]))
    return fake


class _FakePipeline:
    """The JAX trainer's pipeline without augmentation: zero batches."""

    def __init__(self, trainset, cfg, **kwargs):
        self.crop_size = tuple(cfg.training_size)

    def next_batch(self, batch):
        return (jnp.zeros((batch, *self.crop_size, 1), jnp.float32),
                jnp.zeros((batch, *self.crop_size), jnp.int32))


class _TinyFlax(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Conv(3, (1, 1, 1))(x)


@pytest.mark.parametrize("means,best", [
    ((0.5, 0.5, 0.4), 1),                # >=: the later tie wins
    ((np.nan, 0.2, 0.1), 1),             # NaN never wins
    ((0.0, np.nan, -0.1), 0),            # the first evaluation wins at 0
])
def test_best_rule_matches_the_jax_trainer(tmp_path, monkeypatch, means,
                                           best):
    """Three evaluation epochs with the same fake evaluations in both
    trainers: the same arrays returned, the best checkpoint written at the
    same epochs.  The JAX trainer runs a 1x1-conv model, a zero pipeline
    and a step that changes nothing, the port's trainer the tiny model
    and a step that changes nothing: only the epoch loops are exercised."""
    epochs = len(means)
    port_log, jax_log, jax_saves = [], [], []
    monkeypatch.setattr(trainer, "validate", _fake_validate(means, port_log))
    monkeypatch.setattr(trainer, "make_train_step",
                        lambda model, opt, cfg, mesh=None:
                        lambda state, img, lab, lr: torch.zeros(()))
    monkeypatch.setattr(jax_trainer, "validate",
                        _fake_validate(means, jax_log))
    monkeypatch.setattr(jax_trainer, "TrainPipeline", _FakePipeline)
    monkeypatch.setattr(jax_trainer, "get_model", lambda cfg: _TinyFlax())
    monkeypatch.setattr(jax_trainer, "make_train_step",
                        lambda model, tx, cfg:
                        lambda state, img, lab, lr: (state, jnp.float32(0)))
    monkeypatch.setattr(jax_trainer, "save_checkpoint",
                        lambda path, state, epoch, **kw:
                        jax_saves.append((path.rsplit("/", 1)[1], epoch)))
    d = dict(TRAIN3D, epochs=epochs, **_paths(tmp_path))
    got = trainer.train_net(config_from_dict(d), device="cpu")
    ref = jax_trainer.train_net(jax_config(dict(d, cp_path=str(
        tmp_path / "jax"), log_path=str(tmp_path / "jaxlog"))))
    assert port_log == jax_log == list(range(epochs))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0], _fake_dice(means, best))
    np.testing.assert_array_equal(got[1], [30.0 + best, 40.0 + best])
    jax_best = [e for name, e in jax_saves if name == "fold_0_best.ckpt"]
    port_best = torch.load(str(tmp_path / "exp" / "synthetic" / "v" /
                               "fold_0_best.ckpt"), weights_only=True)
    assert port_best["epoch"] == jax_best[-1] == best + 1


def test_empty_test_split_keeps_the_initial_arrays(tmp_path):
    """Three cases under k_fold 5: the test split is empty, every
    evaluation is NaN, nothing wins (as in the JAX trainer): the initial
    zeros and 1000s come back and no best checkpoint is written."""
    cfg = config_from_dict(dict(TRAIN3D, synthetic_cases=3, k_fold=5,
                                epochs=1, **_paths(tmp_path)))
    dice, hd, asd = trainer.train_net(cfg, device="cpu")
    np.testing.assert_array_equal(dice, np.zeros(3))
    np.testing.assert_array_equal(hd, np.full(3, 1000.0))
    np.testing.assert_array_equal(asd, np.full(3, 1000.0))
    run = tmp_path / "exp" / "synthetic" / "v"
    assert (run / "fold_0_latest.ckpt").exists()
    assert not (run / "fold_0_best.ckpt").exists()
    avg = [r["value"] for r in _scalars(tmp_path)
           if r["tag"] == "Dice/test_AVG"]
    assert len(avg) == 1 and np.isnan(avg[0])
