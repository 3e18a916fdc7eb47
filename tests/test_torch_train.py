"""The port's training path vs ``cbim_tpu``'s, on the CPU.

Losses, schedule, optimizers, the synthetic dataset, the pipeline's host
windows, and a 3-step train trajectory of a tiny MedFormer-3D against
``make_train_step``; then what the port must do on its own: keep the
autograd graph through the kernel Functions, keep fp32 parameters when
training, refuse what it has not ported, checkpoint and resume, and run
``python -m cbim_tpu_torch.train`` end to end.  Inputs come from numpy
with a seed.
"""

import functools
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.data import native as jax_native
from cbim_tpu.data.datasets import Synthetic3D as JaxSynthetic3D
from cbim_tpu.data.pipeline import TrainPipeline as JaxTrainPipeline
from cbim_tpu.ops import losses as jax_losses
from cbim_tpu.training import schedules as jax_schedules
from cbim_tpu.training.optim import get_optimizer as jax_get_optimizer
from cbim_tpu.training.train_state import create_train_state as jax_create
from cbim_tpu.training.train_state import make_train_step as jax_make_step
from cbim_tpu_torch import train as train_cli
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.datasets import Synthetic3D
from cbim_tpu_torch.data.pipeline import TrainPipeline
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.ops import losses
from cbim_tpu_torch.ops.kernels import conv3d, fused_norm
from cbim_tpu_torch.training import schedules
from cbim_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from cbim_tpu_torch.training.optim import get_optimizer, set_lr
from cbim_tpu_torch.training.train_state import (create_train_state,
                                                 eval_variables,
                                                 make_train_step)
from cbim_tpu_torch.training.trainer import train_net
from cbim_tpu_torch.utils.jax_import import medformer3d_state_dict_from_jax
from test_torch_medformer import TINY, jax_medformer
from test_torch_threads import few_torch_threads  # noqa: F401

#: the training keys of the flagship recipe (bench.py:70-89) on TINY
TRAIN = dict(
    TINY, aux_weight=[0.5, 0.5], weight=[0.5, 1.0, 1.0], rlt=1,
    optimizer="adamw", base_lr=1e-3, betas=[0.9, 0.999], weight_decay=0.05,
    ema=True, ema_alpha=0.99, attn_drop=0.0, proj_drop=0.0,
    training_size=[32, 32, 32], affine_pad_size=[6, 6, 6],
    scale=[0.3, 0.3, 0.3], rotate=[30, 30, 30], translate=[0, 0, 0],
    gaussian_noise_std=0.02, synthetic_cases=3,
    synthetic_shape=[40, 36, 44], k_fold=5, split_seed=0, device_cache=False)


# ------------------------------------------------------------------ losses

def _logits_and_target(seed, shape=(2, 4, 6, 5), C=4):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(*shape, C)) * 2).astype(np.float32)
    target = rng.integers(0, C, size=shape).astype(np.int32)
    return logits, target


LOSSES = {
    "dice": (lambda l, t: jax_losses.dice_loss(l, t),
             lambda l, t: losses.dice_loss(l, t)),
    "weighted_ce": (
        lambda l, t: jax_losses.weighted_cross_entropy(
            l, t, jnp.asarray([0.5, 1.0, 2.0, 1.0])),
        lambda l, t: losses.weighted_cross_entropy(l, t, [0.5, 1.0, 2.0, 1.0])),
    "deep_supervision": (
        lambda l, t: jax_losses.deep_supervision_loss(
            [l, 0.5 * l], t, [0.5, 0.5], jnp.asarray([0.5, 1.0, 2.0, 1.0]), 2.0),
        lambda l, t: losses.deep_supervision_loss(
            [l, 0.5 * l], t, [0.5, 0.5], [0.5, 1.0, 2.0, 1.0], 2.0)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_grad_match_jax(name):
    """Channels-last logits on the JAX side, NCDHW on the port's."""
    jax_fn, torch_fn = LOSSES[name]
    logits, target = _logits_and_target(len(name))
    j_val, j_grad = jax.value_and_grad(jax_fn)(jnp.asarray(logits),
                                               jnp.asarray(target))
    tl = torch.from_numpy(logits).movedim(-1, 1).requires_grad_()
    val = torch_fn(tl, torch.from_numpy(target))
    val.backward()
    # fp32 sums over 240 voxels in another order
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-6)
    np.testing.assert_allclose(tl.grad.movedim(1, -1).numpy(),
                               np.asarray(j_grad), rtol=1e-5, atol=1e-7)


def test_focal_loss_matches_jax():
    logits, target = _logits_and_target(9)
    ref = jax_losses.focal_loss(jnp.asarray(logits), jnp.asarray(target),
                                alpha=jnp.asarray([1.0, 0.5, 0.5, 2.0]))
    val = losses.focal_loss(torch.from_numpy(logits).movedim(-1, 1),
                            torch.from_numpy(target), alpha=[1.0, 0.5, 0.5, 2.0])
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-6)


# ------------------------------------------------- schedule and optimizers

def test_lr_schedule_matches_jax():
    for epoch in range(0, 40):
        assert schedules.exp_lr_scheduler_with_warmup(1e-3, epoch, 5, 40) == \
            jax_schedules.exp_lr_scheduler_with_warmup(1e-3, epoch, 5, 40)


@pytest.mark.parametrize("current_lr", [None, 3e-4])
def test_multistep_lr_schedule_matches_jax(current_lr):
    """Warmup, the decay epochs and the epochs between them, with the
    running LR given and not, over epochs 0 to max."""
    for epoch in range(0, 41):
        args = (1e-3, epoch, 5, [15, 25, 35], 40)
        assert schedules.multistep_lr_scheduler_with_warmup(
            *args, gamma=0.2, current_lr=current_lr) == \
            jax_schedules.multistep_lr_scheduler_with_warmup(
                *args, gamma=0.2, current_lr=current_lr)


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizer_steps_match_optax(name):
    """Three steps at a changing LR on one parameter tensor."""
    cfg = dict(optimizer=name, base_lr=0.1, momentum=0.9, betas=[0.9, 0.99],
               weight_decay=0.05)
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) * 10 ** -i
             for i in range(3)]
    tx = jax_get_optimizer(jax_config(cfg))
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = get_optimizer(config_from_dict(cfg), [p])
    for i, g in enumerate(grads):
        lr = 0.1 / (i + 1)
        opt_state.hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = jp + upd
        set_lr(opt, lr)
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-6)


# -------------------------------------------------------- data and pipeline

def test_synthetic_volumes_and_split_match_jax():
    jc, tc = jax_config(TRAIN), config_from_dict(TRAIN)
    for mode, fold in (("train", 0), ("test", 1)):
        j = JaxSynthetic3D(jc, mode=mode, k_fold=2, k=fold, seed=3)
        t = Synthetic3D(tc, mode=mode, k_fold=2, k=fold, seed=3)
        assert len(t) == len(j) > 0
        for a, b in zip(t.images + t.labels, j.images + j.labels):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the training-size pad (+2 in y/x, ceil halves) on a small volume
    small = dict(TRAIN, synthetic_shape=[30, 29, 33])
    a = Synthetic3D(config_from_dict(small), k_fold=5)
    b = JaxSynthetic3D(jax_config(small), k_fold=5)
    assert a.images[0].shape == b.images[0].shape == (32, 35, 33)
    np.testing.assert_array_equal(a.images[0], b.images[0])


def test_host_batch_windows_match_jax_pipeline(monkeypatch):
    """Same seed, same numpy calls: the same volumes and windows."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    jc, tc = jax_config(TRAIN), config_from_dict(TRAIN)
    j_pipe = JaxTrainPipeline(JaxSynthetic3D(jc), jc, seed=5)
    t_pipe = TrainPipeline(Synthetic3D(tc), tc, seed=5, device="cpu")
    assert t_pipe.buffer_shape == j_pipe.buffer_shape == (38, 38, 38)
    for _ in range(3):
        (ti, tl), (ji, jl) = t_pipe.host_batch(2), j_pipe.host_batch(2)
        assert ti.dtype == ji.dtype and tl.dtype == jl.dtype
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_next_batch_shapes_and_labels():
    cfg = config_from_dict(TRAIN)
    pipe = TrainPipeline(Synthetic3D(cfg), cfg, seed=0, device="cpu")
    img, lab = pipe.next_batch(2)
    assert img.shape == (2, 32, 32, 32, 1) and img.dtype == torch.float32
    assert lab.shape == (2, 32, 32, 32) and lab.dtype == torch.int64
    assert set(lab.unique().tolist()) <= set(range(TRAIN["classes"]))
    assert torch.isfinite(img).all()


# ------------------------------------------------------- train trajectory

TRAJ_SIZE, TRAJ_LR = 32, 1e-3


@functools.lru_cache(maxsize=None)
def _jax_trajectory():
    """Three fixed batches through ``make_train_step`` (fp32, AdamW + EMA):
    the batches, the initial params, the step-0 gradients (read back from
    the first step's AdamW moment, mu = (1 - b1) g from zeros: the step's
    one compile serves both), the losses, and the params and EMA params
    after three steps."""
    S = TRAJ_SIZE
    rng = np.random.default_rng(0)
    imgs = [rng.normal(size=(2, S, S, S, 1)).astype(np.float32)
            for _ in range(3)]
    labs = [rng.integers(0, 3, size=(2, S, S, S)).astype(np.int32)
            for _ in range(3)]
    jc = jax_config(TRAIN)
    jm = jax_medformer(TRAIN)
    state, tx = jax_create(jm, jc, jax.random.PRNGKey(0),
                           jnp.zeros((1, S, S, S, 1)))
    params0 = jax.tree.map(np.asarray, state.params)
    j_step = jax.jit(jax_make_step(jm, tx, jc))
    j_losses, j_grads = [], None
    for img, lab in zip(imgs, labs):
        state, loss = j_step(state, jnp.asarray(img), jnp.asarray(lab),
                             TRAJ_LR)
        if j_grads is None:
            adam, = [s for s in state.opt_state.inner_state
                     if hasattr(s, "mu")]
            j_grads = jax.tree.map(
                lambda m: np.asarray(m) / (1.0 - TRAIN["betas"][0]), adam.mu)
        j_losses.append(float(loss))
    return (imgs, labs, params0, j_grads, j_losses,
            jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.ema_params))


def _check_trajectory(d):
    """The port's model of config ``d`` (TRAIN, or TRAIN with options that
    keep its function) against :func:`_jax_trajectory`."""
    imgs, labs, params0, j_grads, j_losses, j_params, j_ema = \
        _jax_trajectory()
    tc = config_from_dict(d)
    model = get_model(tc, device="cpu", train=True)
    model.load_state_dict(medformer3d_state_dict_from_jax(params0, tc))
    t_state = create_train_state(model, tc)
    step = make_train_step(model, t_state.optimizer, tc)

    out = model(torch.from_numpy(imgs[0]).movedim(-1, 1))
    losses.deep_supervision_loss(out, torch.from_numpy(labs[0]), [0.5, 0.5],
                                 TRAIN["weight"], 1.0).backward()
    j_grad_sd = medformer3d_state_dict_from_jax(j_grads, tc)
    for k, p in model.named_parameters():
        # fp32 both sides, sums in another order; |grad| <= 0.14 here
        np.testing.assert_allclose(p.grad.numpy(), j_grad_sd[k], rtol=1e-4,
                                   atol=5e-6, err_msg=k)

    t_losses = [float(step(t_state, torch.from_numpy(img),
                           torch.from_numpy(lab), TRAJ_LR))
                for img, lab in zip(imgs, labs)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_state.step == 3

    # AdamW moves a parameter by lr * m/(sqrt(v) + eps); its derivative in
    # the gradient is at most lr / eps = 100, so gradients that agree to
    # 5e-6 move a parameter apart by at most 5e-4 a step: 1.5e-3 in three.
    # The EMA is a convex mix of those parameters.
    j_params = medformer3d_state_dict_from_jax(j_params, tc)
    j_ema = medformer3d_state_dict_from_jax(j_ema, tc)
    for sd, ref in ((model.state_dict(), j_params),
                    (eval_variables(t_state, True).state_dict(), j_ema)):
        for k in sd:
            np.testing.assert_allclose(sd[k].numpy(), ref[k], rtol=0,
                                       atol=1.5e-3, err_msg=k)


def test_three_step_trajectory_matches_make_train_step():
    """fp32, AdamW + EMA, dropout off, three fixed batches, weights carried
    by ``medformer3d_state_dict_from_jax``: the losses and the step-0
    gradients, then the params and EMA params after three steps."""
    _check_trajectory(TRAIN)


def test_three_step_trajectory_with_conv_na_matches_make_train_step(
        monkeypatch):
    """The same trajectory with ``conv_na``: the BasicBlocks' convs train
    through ``ConvInormAct3d`` (dgrad, the na wgrad and the InstanceNorm
    backward) and follow the JAX model's unfused chain, which computes the
    same function, at the same tolerances."""
    calls = []
    fused_apply = conv3d.ConvInormAct3d.apply

    def counting(*args):
        calls.append(1)
        return fused_apply(*args)

    monkeypatch.setattr(conv3d.ConvInormAct3d, "apply", counting)
    _check_trajectory(dict(TRAIN, conv_na=True))
    assert calls


# ------------------------------------------ what the port does on its own

def test_kernel_functions_keep_the_graph_and_every_parameter_learns():
    """Fault 1: the kernel wrappers once filled tensors through ctypes with
    no ``grad_fn``.  Their Functions carry the graph (the same Functions
    run on the card), and every parameter of the model gets a gradient."""
    x = torch.randn(1, 4, 4, 4, 8, requires_grad=True)
    assert conv3d.Conv3dSame.apply(x, torch.randn(8, 8, 3, 3, 3)).grad_fn
    assert fused_norm.instance_norm_act(x, 1e-4, "gelu").grad_fn is not None
    cfg = config_from_dict(TRAIN)
    model = get_model(cfg, device="cpu", train=True,
                      generator=torch.Generator().manual_seed(0))
    img = torch.randn(1, 1, 32, 32, 32, generator=torch.Generator().manual_seed(1))
    lab = torch.randint(0, 3, (1, 32, 32, 32),
                        generator=torch.Generator().manual_seed(2))
    losses.deep_supervision_loss(model(img), lab, [0.5, 0.5]).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name


def test_get_model_keeps_fp32_parameters_for_training():
    """Fault 2: with amp the serving model is cast to bf16; the training
    model keeps fp32 master weights in train mode."""
    cfg = config_from_dict(dict(TRAIN, amp=True))
    assert cfg.compute_dtype == "bfloat16"
    train_model = get_model(cfg, device="cpu", train=True)
    assert train_model.training
    assert all(p.dtype == torch.float32 for p in train_model.parameters())
    serve_model = get_model(cfg, device="cpu")
    assert not serve_model.training
    assert all(p.dtype == torch.bfloat16 for p in serve_model.parameters())


@pytest.mark.parametrize("key", ["attn_drop", "proj_drop"])
def test_dropout_is_refused(key):
    """Fault 3, repaired: dropout is ported, and draws from the train
    state's generator; a training-mode forward without one is refused
    instead of running without dropout."""
    model = get_model(config_from_dict(dict(TRAIN, **{key: 0.1})),
                      device="cpu", train=True)
    with pytest.raises(RuntimeError, match="generator"):
        model(torch.zeros(1, 1, *TRAIN["training_size"]))


def _defaults_to_the_card(fn, call):
    """``fn`` defaults to device 'cuda', and ``call()`` (no device given)
    raises where torch sees no usable card: the CPU runs only when asked."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_train_net_defaults_to_the_card(tmp_path):
    cfg = config_from_dict(dict(TRAIN, epochs=1, val_freq=5,
                                cp_path=str(tmp_path / "exp"),
                                log_path=str(tmp_path / "log")))
    _defaults_to_the_card(train_net, lambda: train_net(cfg))
    assert not (tmp_path / "exp").exists()     # it raised before starting


def test_train_pipeline_defaults_to_the_card():
    cfg = config_from_dict(TRAIN)
    _defaults_to_the_card(TrainPipeline,
                          lambda: TrainPipeline(Synthetic3D(cfg), cfg))


def test_remat_recomputes_the_same_gradients():
    """Per-stage checkpointing ('all') runs each stage's forward again in
    the backward pass, in train mode only, and gives the gradients of no
    remat; the mode names are checked."""
    grads = {}
    img = torch.randn(1, 1, 32, 32, 32,
                      generator=torch.Generator().manual_seed(1))
    for remat in (False, True):
        model = get_model(config_from_dict(dict(TRAIN, remat=remat)),
                          device="cpu", train=True,
                          generator=torch.Generator().manual_seed(0))
        calls = []
        model.up4.register_forward_pre_hook(lambda *a: calls.append(1))
        model(img)[0].square().mean().backward()
        assert len(calls) == (2 if remat else 1)
        grads[remat] = {k: p.grad for k, p in model.named_parameters()}
    for k in grads[False]:
        torch.testing.assert_close(grads[True][k], grads[False][k],
                                   rtol=1e-5, atol=1e-7)
    model.eval()
    model(img)[0].square().mean().backward()
    assert len(calls) == 3                          # no recompute in eval
    with pytest.raises(ValueError):
        get_model(config_from_dict(dict(TRAIN, remat="some")), device="cpu",
                  train=True)


def test_checkpoint_round_trip_restores_the_state(tmp_path):
    cfg = config_from_dict(TRAIN)
    gen = torch.Generator().manual_seed(0)
    state = create_train_state(
        get_model(cfg, device="cpu", train=True, generator=gen), cfg)
    step = make_train_step(state.model, state.optimizer, cfg)
    img = torch.randn(1, 32, 32, 32, 1)
    lab = torch.randint(0, 3, (1, 32, 32, 32))
    step(state, img, lab, 1e-3)
    path = str(tmp_path / "fold_0_latest.ckpt")
    save_checkpoint(path, state, epoch=3)

    fresh = create_train_state(get_model(cfg, device="cpu", train=True), cfg)
    fresh, epoch = load_checkpoint(path, fresh)
    assert epoch == 3 and fresh.step == 1
    for a, b in ((fresh.model, state.model), (fresh.ema, state.ema)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    # the next steps from the restored state equal the original's
    step2 = make_train_step(fresh.model, fresh.optimizer, cfg)
    assert float(step2(fresh, img, lab, 1e-3)) == float(step(state, img, lab, 1e-3))
    for v, w in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(v, w)


def _cli_args(tmp_path, *extra):
    return ["--dataset", "synthetic", "--model", "medformer", "--dimension",
            "3d", "--batch_size", "2", "--cp_path", str(tmp_path / "exp"),
            "--log_path", str(tmp_path / "log"), "--unique_name", "t",
            "--folds", "1", "--device", "cpu", *extra]


def test_train_cli_runs_on_the_cpu(tmp_path):
    cfg = config_from_dict(dict(TRAIN, epochs=2, iter_per_epoch=2,
                                print_freq=1, val_freq=5, remat=True))
    results = train_cli.main(_cli_args(tmp_path), cfg=cfg)
    assert len(results) == 1
    run = tmp_path / "exp" / "synthetic" / "t"
    assert (run / "fold_0_latest.ckpt").exists()
    assert (run / "cross_validation.txt").read_text().startswith("Dice")
    assert "batch_size: 2" in (run / "config.txt").read_text()
    rows = [json.loads(ln) for ln in
            (tmp_path / "log" / "synthetic" / "t" / "fold_0" /
             "scalars.jsonl").read_text().splitlines()]
    step_losses = [r["value"] for r in rows if r["tag"] == "Train/StepLoss"]
    assert len(step_losses) == 4 and np.isfinite(step_losses).all()
    assert any(r["tag"] == "Perf/volumes_per_sec_per_chip" for r in rows)

    # --pretrain with a .pth loads strictly; a resume continues the epochs
    weights = tmp_path / "w.pth"
    torch.save(get_model(cfg, device="cpu", train=True).state_dict(), weights)
    train_cli.main(_cli_args(tmp_path, "--pretrain", "--init_model",
                             str(weights), "--unique_name", "p"), cfg=cfg)
    ckpt = str(run / "fold_0_latest.ckpt")
    more = config_from_dict(dict(cfg.__dict__, epochs=3))
    train_cli.main(_cli_args(tmp_path, "--resume", "--load", ckpt,
                             "--unique_name", "r"), cfg=more)
    payload = torch.load(str(tmp_path / "exp" / "synthetic" / "r" /
                             "fold_0_latest.ckpt"), weights_only=True)
    assert payload["epoch"] == 3 and payload["step"] == 6
    # a .npz initialises TransUNet only (its official backbone)
    with pytest.raises(NotImplementedError, match="TransUNet"):
        train_cli.main(_cli_args(tmp_path, "--pretrain", "--init_model",
                                 "backbone.npz"), cfg=cfg)


def test_unported_datasets_raise():
    """Every dataset of the JAX package's registry is ported; a name it
    does not register (for that dimension) raises its ``ValueError``."""
    from cbim_tpu_torch.data.factory import get_dataset
    with pytest.raises(ValueError, match="unknown dataset 'brats'"):
        get_dataset(config_from_dict(dict(TRAIN, dataset="brats")))
    with pytest.raises(ValueError, match="unknown dataset 'amos_ct'"):
        get_dataset(config_from_dict(dict(TRAIN, dataset="amos_ct",
                                          dimension="2d")))
