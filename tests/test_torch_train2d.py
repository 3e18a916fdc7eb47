"""The port's 2D training path vs ``cbim_tpu``'s, on the CPU.

MedFormer-2D trains with BatchNorm, so the step carries running statistics:
they are held against Flax's after a train-mode forward and along a 3-step
trajectory of ``make_train_step``, with the EMA copying them as the JAX
step does.  Then the 2D data path: ``Synthetic2D``'s slices, the epoch's
draws without replacement (ROADMAP C3), ``random_theta_2d`` from the JAX
draws, ``affine_sample_2d_batch`` against ``affine_sample_2d``, and
``python -m cbim_tpu_torch.train --dimension 2d`` end to end.  Inputs come
from numpy with a seed.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.data.datasets import Synthetic2D as JaxSynthetic2D
from cbim_tpu.data.pipeline import TrainPipeline as JaxTrainPipeline
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.ops import augment as jax_aug
from cbim_tpu.ops.resample import affine_sample_2d as jax_affine_2d
from cbim_tpu.training.train_state import create_train_state as jax_create
from cbim_tpu.training.train_state import make_train_step as jax_make_step
from cbim_tpu_torch import train as train_cli
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.datasets import Synthetic2D
from cbim_tpu_torch.data.pipeline import AugRecipe, TrainPipeline, build_batch_aug
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers.convs import Norm
from cbim_tpu_torch.ops import augment
from cbim_tpu_torch.ops.resample import affine_sample_2d_batch
from cbim_tpu_torch.training.train_state import (create_train_state,
                                                 eval_variables,
                                                 make_train_step)
from cbim_tpu_torch.utils.jax_import import medformer2d_state_dict_from_jax
from test_torch_medformer2d import TINY2D, jax_variables
from test_torch_threads import few_torch_threads  # noqa: F401

#: the ACDC recipe's training keys (configs/acdc/medformer_2d.yaml) on the
#: narrow model, at 32^2 crops
TRAIN2D = dict(
    TINY2D, aux_weight=[0.5, 0.5], weight=[0.5, 1.0, 1.0, 1.0], rlt=1,
    optimizer="adamw", base_lr=5e-4, betas=[0.9, 0.999], weight_decay=0.05,
    ema=True, ema_alpha=0.99, training_size=[32, 32], affine_pad_size=[8, 8],
    scale=0.3, rotate=180, translate=0, gaussian_noise_std=0.02,
    synthetic_cases=3, k_fold=5, split_seed=0, device_cache=False)


def _running(sd):
    """{name: running_mean/var} of every BatchNorm in a state_dict, as
    numpy copies (a state_dict's tensors are the live buffers)."""
    return {k: v.numpy().copy() for k, v in sd.items() if "running" in k}


# ------------------------------------------------------------- BatchNorm

def test_batchnorm_running_stats_after_a_train_forward_match_flax():
    """One train-mode forward: the batch-statistics output and the updated
    running statistics, Flax ``BatchNorm(momentum=0.9)`` (biased batch
    variance) against the port's ``Norm("bn")``."""
    jm, v = jax_variables(TINY2D, seed=7)
    cfg = config_from_dict(TINY2D)
    model = get_model(cfg, device="cpu", train=True)
    model.load_state_dict(medformer2d_state_dict_from_jax(v, cfg))
    x = np.random.default_rng(4).normal(size=(3, 32, 32, 1)).astype(np.float32)
    (j_out, _), upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    t_out, _ = model(torch.from_numpy(x).movedim(-1, 1))
    # fp32 both sides, batch statistics in another summation order
    np.testing.assert_allclose(t_out.detach().movedim(1, -1).numpy(),
                               np.asarray(j_out), rtol=1e-4, atol=1e-4)
    ref = _running(medformer2d_state_dict_from_jax(
        {"params": v["params"],
         "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])}, cfg))
    got = _running(model.state_dict())
    assert got.keys() == ref.keys() and len(got) > 0
    for k in ref:
        # the semantic-map norms see 3 x 2 x 2 values per channel: an
        # unbiased variance would be 12/11 of Flax's, 9e-2 off
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert int(model.state_dict()["inc.conv2.conv1.norm.num_batches_tracked"]) == 1


def test_batchnorm_eval_reads_running_stats_and_leaves_them():
    gen = torch.Generator().manual_seed(0)
    norm = Norm("bn", eps=1e-5, channels=3)
    norm.running_mean.normal_(generator=gen)
    norm.running_var.uniform_(0.5, 2.0, generator=gen)
    x = torch.randn(2, 3, 4, 5, generator=gen)
    before = norm.running_var.clone()
    y = norm.eval()(x, act="relu")
    ref = torch.relu((x - norm.running_mean.view(1, 3, 1, 1))
                     / torch.sqrt(norm.running_var.view(1, 3, 1, 1) + 1e-5))
    torch.testing.assert_close(y, ref)
    assert torch.equal(norm.running_var, before)
    norm.train()(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(norm.running_var, 0.9 * before + 0.1 * var)


# ------------------------------------------------------- train trajectory

def test_three_step_2d_trajectory_matches_make_train_step():
    """fp32, AdamW + EMA, three fixed batches, the Flax initial variables
    carried by ``medformer2d_state_dict_from_jax``: losses within 1e-4
    relative; then the running statistics, which the EMA model copies."""
    S, lr = 32, 5e-4
    rng = np.random.default_rng(0)
    imgs = [rng.normal(size=(4, S, S, 1)).astype(np.float32) for _ in range(3)]
    labs = [rng.integers(0, 4, size=(4, S, S)).astype(np.int32)
            for _ in range(3)]
    jc, tc = jax_config(TRAIN2D), config_from_dict(TRAIN2D)
    # the model alone: jax_create compiles the one init the test needs
    jm = jax_get_model(config_from_dict(TRAIN2D))
    state, tx = jax_create(jm, jc, jax.random.PRNGKey(0),
                           jnp.zeros((1, S, S, 1)))
    v0 = jax.tree.map(np.asarray, {"params": state.params,
                                   "batch_stats": state.batch_stats})
    j_step = jax.jit(jax_make_step(jm, tx, jc))
    j_losses, j_stats = [], []
    for img, lab in zip(imgs, labs):
        state, loss = j_step(state, jnp.asarray(img), jnp.asarray(lab), lr)
        j_losses.append(float(loss))
        j_stats.append(_running(medformer2d_state_dict_from_jax(
            jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats}),
            tc)))

    model = get_model(tc, device="cpu", train=True)
    model.load_state_dict(medformer2d_state_dict_from_jax(v0, tc))
    t_state = create_train_state(model, tc)
    assert model.training and not t_state.ema.training
    step = make_train_step(model, t_state.optimizer, tc)
    t_losses, t_stats = [], []
    for img, lab in zip(imgs, labs):
        t_losses.append(float(step(t_state, torch.from_numpy(img),
                                   torch.from_numpy(lab), lr)))
        t_stats.append(_running(model.state_dict()))
        ema = eval_variables(t_state, True).state_dict()
        for k, got in t_stats[-1].items():
            assert np.array_equal(ema[k].numpy(), got), k
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)

    for k in j_stats[0]:
        # step 1 normalises with the initial parameters on both sides: its
        # running statistics agree to fp32 noise
        np.testing.assert_allclose(t_stats[0][k], j_stats[0][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        # AdamW's first steps move a parameter by about lr = 5e-4 whatever
        # the gradient's size, so where a gradient is fp32 noise the sides
        # step apart by up to 2 * lr; the batch statistics of steps 2-3
        # come from parameters that differ so, 1.6e-3 of an O(1) variance
        # at most here
        np.testing.assert_allclose(t_stats[2][k], j_stats[2][k], rtol=3e-3,
                                   atol=1e-3, err_msg=k)


def test_ema_copies_buffers_and_averages_parameters():
    """The EMA state after a step: the live model's buffers as they are (JAX
    ``ema_batch_stats = new_stats``), the parameters' running average."""
    cfg = config_from_dict(TRAIN2D)
    state = create_train_state(
        get_model(cfg, device="cpu", train=True,
                  generator=torch.Generator().manual_seed(0)),
        cfg)
    step = make_train_step(state.model, state.optimizer, cfg)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        step(state, torch.randn(2, 32, 32, 1, generator=gen),
             torch.randint(0, 4, (2, 32, 32), generator=gen), 1e-3)
    live, ema = state.model.state_dict(), state.ema.state_dict()
    buffers = [k for k in live if "running" in k or "num_batches" in k]
    assert buffers
    for k in buffers:
        assert torch.equal(live[k], ema[k]), k
    assert int(ema["outc.weight"].ne(live["outc.weight"]).sum()) > 0


# ------------------------------------------------------------ 2D data path

def test_synthetic_2d_slices_match_jax():
    jc, tc = jax_config(TRAIN2D), config_from_dict(TRAIN2D)
    j, t = JaxSynthetic2D(jc), Synthetic2D(tc)
    assert len(t) == len(j) == 18 and t.dimension == "2d"
    for a, b in zip(t.images + t.labels, j.images + j.labels):
        assert a.shape == (40, 40) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch", [4, 5])
def test_2d_draws_are_epochs_without_replacement_like_jax(batch):
    """ROADMAP C3, decided: the port keeps the JAX package's epoch tail.
    Draws run through per-epoch permutations; a batch that reaches the end
    of one takes its rest from the next, so every slice is drawn once per
    18 draws and the host windows equal the JAX package's."""
    jc, tc = jax_config(TRAIN2D), config_from_dict(TRAIN2D)
    j_pipe = JaxTrainPipeline(JaxSynthetic2D(jc), jc, seed=5)
    t_pipe = TrainPipeline(Synthetic2D(tc), tc, seed=5, device="cpu")
    assert t_pipe.buffer_shape == j_pipe.buffer_shape == (40, 40)
    drawn = []
    for _ in range(8):
        (ti, tl), (ji, jl) = t_pipe.host_batch(batch), j_pipe.host_batch(batch)
        assert ti.shape == (batch, 40, 40, 1) and tl.dtype == np.int8
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        drawn += t_pipe._epoch_perm.tolist() if not drawn else []
    # the same windows: the index stream itself, epoch by epoch
    t_pipe2 = TrainPipeline(Synthetic2D(tc), tc, seed=9, device="cpu")
    idx = np.concatenate([t_pipe2._draw_indices(batch) for _ in range(9)])
    for e in range(len(idx) // 18):
        assert sorted(idx[18 * e:18 * (e + 1)]) == list(range(18))


def _jax_theta_2d_draws(key, scale, rotate, translate):
    """The numbers ``cbim_tpu.ops.augment.random_theta_2d`` draws from
    ``key``, by the same calls."""
    ks = jax.random.split(key, 7)

    def u(k):
        return float(jax.random.uniform(k, (), jnp.float32, 0.0, 1.0))

    scales = [1 - scale + u(ks[i]) * 2 * scale for i in (0, 1)]
    shears = [u(ks[i]) * 2 * scale - scale for i in (2, 3)]
    trans = [u(ks[i]) * 2 * translate - translate for i in (4, 5)]
    deg = int(jax.random.randint(ks[6], (), -int(rotate), max(int(rotate), 1)))
    return scales, shears, trans, deg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_theta_from_jax_draws_matches_random_theta_2d(seed):
    key = jax.random.PRNGKey(seed)
    ref = jax_aug.random_theta_2d(key, 0.3, 180, 0.1)
    scales, shears, trans, deg = _jax_theta_2d_draws(key, 0.3, 180, 0.1)
    th = augment.theta_2d_from_draws([scales], [shears], [trans], [deg])
    assert th.shape == (1, 2, 3)
    # fp32 products of cos/sin and scales: a few ulp of O(1) entries
    np.testing.assert_allclose(th[0].numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_random_theta_2d_draws_stay_in_their_ranges():
    gen = torch.Generator().manual_seed(0)
    th = augment.random_theta_2d(gen, 4000, scale=0.3, rotate=0,
                                 translate=0.1)
    # no rotation: theta = S, scales on the diagonal, shears off it
    diag = torch.stack([th[:, 0, 0], th[:, 1, 1]])
    off = torch.stack([th[:, 0, 1], th[:, 1, 0]])
    assert 0.7 <= float(diag.min()) and float(diag.max()) <= 1.3
    assert float(off.abs().max()) <= 0.3 and float(off.abs().max()) > 0.25
    assert float(th[:, :, 2].abs().max()) <= 0.1
    rot = augment.random_theta_2d(gen, 2000, scale=0.0, rotate=180)
    deg = torch.rad2deg(torch.atan2(rot[:, 1, 0], rot[:, 0, 0]))
    assert float(deg.min()) < -170 and float(deg.max()) > 170


@pytest.mark.parametrize("shape,out", [((20, 24), (12, 16)), ((9, 11), (9, 11))])
def test_affine_sample_2d_batch_matches_jax(shape, out):
    """Bilinear image and nearest labels, centre crop fused, zeros outside:
    the image to 1e-5 and the labels exactly."""
    rng = np.random.default_rng(sum(shape))
    img = rng.normal(size=(3, *shape, 2)).astype(np.float32)
    lab = rng.integers(0, 4, size=(3, *shape)).astype(np.int8)
    th = np.tile(np.eye(2, 3, dtype=np.float32), (3, 1, 1))
    th[1:] += rng.uniform(-0.3, 0.3, size=(2, 2, 3)).astype(np.float32)
    j_img, j_lab = jax.vmap(lambda i, l, t: jax_affine_2d(
        i, l, t, out_shape=out))(jnp.asarray(img), jnp.asarray(lab),
                                 jnp.asarray(th))
    t_img, t_lab = affine_sample_2d_batch(
        torch.from_numpy(img), torch.from_numpy(lab), torch.from_numpy(th),
        out_shape=out)
    assert t_img.shape == (3, *out, 2) and t_lab.dtype == torch.int8
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))
    oy, ox = [(s - o) // 2 for s, o in zip(shape, out)]
    np.testing.assert_allclose(t_img[0].numpy(),
                               img[0, oy:oy + out[0], ox:ox + out[1]],
                               atol=1e-5)


def test_2d_batch_aug_shapes_and_labels():
    recipe = AugRecipe(affine_pad=(8, 8), scale=0.3, rotate=180,
                       translate=0.0,
                       pre_ops=(("gaussian_noise", 1.0, {"std": 0.02}),))
    fn = build_batch_aug(recipe, (32, 32))
    gen = torch.Generator().manual_seed(0)
    imgs = torch.randn(4, 40, 40, 1, generator=gen)
    labs = torch.randint(0, 4, (4, 40, 40), generator=gen)
    out_img, out_lab = fn(imgs, labs, torch.Generator().manual_seed(1),
                          torch.Generator().manual_seed(2))
    assert out_img.shape == (4, 32, 32, 1) and out_lab.shape == (4, 32, 32)
    assert set(out_lab.unique().tolist()) <= {0, 1, 2, 3}
    assert torch.isfinite(out_img).all()


# --------------------------------------------------------------------- CLI

def test_train_cli_2d_runs_on_the_cpu(tmp_path):
    """An epoch is slice count // batch steps (18 // 4 = 4), as the JAX
    trainer's 2D epoch."""
    cfg = config_from_dict(dict(TRAIN2D, epochs=2, print_freq=1, val_freq=5))
    train_cli.main(["--dataset", "synthetic", "--model", "medformer",
                    "--dimension", "2d", "--batch_size", "4", "--cp_path",
                    str(tmp_path / "exp"), "--log_path", str(tmp_path / "log"),
                    "--unique_name", "t2", "--folds", "1", "--device", "cpu"],
                   cfg=cfg)
    assert (tmp_path / "exp" / "synthetic" / "t2" / "fold_0_latest.ckpt").exists()
    rows = [json.loads(ln) for ln in
            (tmp_path / "log" / "synthetic" / "t2" / "fold_0" /
             "scalars.jsonl").read_text().splitlines()]
    step_losses = [r["value"] for r in rows if r["tag"] == "Train/StepLoss"]
    assert len(step_losses) == 8 and np.isfinite(step_losses).all()


def test_profile_dir_traces_the_first_epochs_steady_steps(tmp_path):
    """The trainer's profiler hook: with ``profile_dir`` the first epoch's
    steps after its first two are traced; on the CPU no device kernel is
    listed."""
    prof = tmp_path / "prof"
    cfg = config_from_dict(dict(TRAIN2D, epochs=1, print_freq=1, val_freq=5,
                                profile_dir=str(prof)))
    train_cli.main(["--dataset", "synthetic", "--model", "medformer",
                    "--dimension", "2d", "--batch_size", "4", "--cp_path",
                    str(tmp_path / "exp"), "--log_path", str(tmp_path / "log"),
                    "--unique_name", "p", "--folds", "1", "--device", "cpu"],
                   cfg=cfg)
    summary = json.loads((prof / "summary.json").read_text())
    assert summary["steps"] == 18 // 4 - 2 and summary["wall_seconds"] > 0
    assert summary["kernels_ms"] == [] and summary["device_busy_share"] == 0
    assert "Self CPU" in (prof / "kernels.txt").read_text()
