"""SwinUNETR training and the Swin layers' training route in the PyTorch
port vs ``cbim_tpu``'s, on the CPU.

In training mode the window attention takes ``window_attention_train``
(the JAX package's XLA path under autograd: the kernel has no backward),
in eval mode the kernel's wrapper.  A 3-step trajectory of a tiny
SwinUNETR is held against ``cbim_tpu.training.train_state.make_train_step``
at ``tests/test_torch_train.py``'s tolerances, and ``DropPath`` against the
JAX formula.  Inputs come from numpy with a seed.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.models.layers.convs import DropPath as JaxDropPath
from cbim_tpu.models.swin_unetr import SwinUNETR as JaxSwinUNETR
from cbim_tpu.ops import losses as jax_losses
from cbim_tpu.training.optim import get_optimizer as jax_get_optimizer
from cbim_tpu.training.train_state import TrainState as JaxTrainState
from cbim_tpu.training.train_state import make_train_step as jax_make_step
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model, swin_layers
from cbim_tpu_torch.ops import losses
from cbim_tpu_torch.ops.kernels import window_attention as wa
from cbim_tpu_torch.training.train_state import (create_train_state,
                                                 eval_variables,
                                                 make_train_step)
from cbim_tpu_torch.utils.jax_import import swin_unetr_state_dict_from_jax
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401

#: the JAX tests' SwinUNETR size with the BCV recipe's training keys
SWIN_TRAIN = dict(
    dataset="synthetic", model="swin_unetr", dimension="3d", classes=3,
    in_chan=1, base_chan=12, training_size=[32, 32, 32], aux_loss=False,
    weight=[0.5, 1.0, 1.0], rlt=1, optimizer="adamw", base_lr=6e-4,
    betas=[0.9, 0.999], weight_decay=0.05, ema=True, ema_alpha=0.99,
    split_seed=0)
TRAJ_SIZE, TRAJ_LR = 32, 1e-3


def trajectory_batches(S, classes, seed=0, nd=3):
    """Three fixed (image, label) batches of 2 x S^nd."""
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=(2, *(S,) * nd, 1)).astype(np.float32)
            for _ in range(3)]
    labs = [rng.integers(0, classes, size=(2, *(S,) * nd)).astype(np.int32)
            for _ in range(3)]
    return imgs, labs


def first_grads(state, new, b1):
    """The step-0 gradients, read back from AdamW's first moment after the
    first step: mu = (1 - b1) g from zeros (fp32, 2^-24 relative)."""
    adam, = [s for s in new.opt_state.inner_state if hasattr(s, "mu")]
    return jax.tree.map(lambda m: np.asarray(m) / (1.0 - b1), adam.mu)


@contextlib.contextmanager
def fast_xla_compile():
    """XLA's optimisations off while inside: a Swin model's train step
    compiles in seconds on the CPU instead of a minute (fp32 all the same;
    only the order of some sums moves)."""
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


def jax_trajectory(jm, d, S, params0, nd=3):
    """Three fixed batches of 2 x S^nd through ``make_train_step`` (fp32,
    AdamW + EMA, deep supervision as ``d`` says) from ``params0``, the
    step's own state otherwise (one compile: the jitted init and a separate
    gradient program would each cost as much): the batches, the step-0
    gradients (from the first step's AdamW moment), the losses, and the
    params and EMA params after three steps."""
    assert d["optimizer"] == "adamw"
    imgs, labs = trajectory_batches(S, d["classes"], nd=nd)
    jc = jax_config(d)
    tx = jax_get_optimizer(jc)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params0,
        opt_state=tx.init(params0), batch_stats={},
        ema_params=jax.tree.map(jnp.array, params0), ema_batch_stats={})
    j_step = jax.jit(jax_make_step(jm, tx, jc))
    j_losses, j_grads = [], None
    for img, lab in zip(imgs, labs):
        new, loss = j_step(state, jnp.asarray(img), jnp.asarray(lab),
                           TRAJ_LR)
        if j_grads is None:
            j_grads = first_grads(state, new, d["betas"][0])
        state = new
        j_losses.append(float(loss))
    return (imgs, labs, params0, j_grads, j_losses,
            jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.ema_params))


def check_trajectory(model, to_sd, cfg_dict, traj):
    """The port's ``model`` (train mode, CPU) against a
    :func:`jax_trajectory`: the step-0 gradients, the three losses, then
    the params and EMA params, at ``tests/test_torch_train.py``'s
    tolerances; ``to_sd`` carries a Flax tree into the port's names."""
    imgs, labs, params0, j_grads, j_losses, j_params, j_ema = traj
    tc = config_from_dict(cfg_dict)
    model.load_state_dict(to_sd(params0))
    t_state = create_train_state(model, tc)
    step = make_train_step(model, t_state.optimizer, tc)

    out = model(torch.from_numpy(imgs[0]).movedim(-1, 1))
    # deep supervision's heads (nnFormer), or one (the rest of the family)
    outs = out if isinstance(out, (list, tuple)) else [out]
    losses.deep_supervision_loss(
        outs, torch.from_numpy(labs[0]),
        cfg_dict["aux_weight"] if cfg_dict["aux_loss"] else [1.0],
        cfg_dict["weight"], 1.0).backward()
    j_grad_sd = to_sd(j_grads)
    for k, p in model.named_parameters():
        # fp32 both sides, sums in another order
        np.testing.assert_allclose(p.grad.numpy(), j_grad_sd[k], rtol=1e-4,
                                   atol=5e-6, err_msg=k)

    t_losses = [float(step(t_state, torch.from_numpy(img),
                           torch.from_numpy(lab), TRAJ_LR))
                for img, lab in zip(imgs, labs)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_state.step == 3
    # AdamW moves a parameter by at most lr / eps = 100 times a gradient's
    # error a step (tests/test_torch_train.py): 1.5e-3 in three
    for sd, ref in ((model.state_dict(), to_sd(j_params)),
                    (eval_variables(t_state, True).state_dict(),
                     to_sd(j_ema))):
        for k in sd:
            np.testing.assert_allclose(sd[k].numpy(), ref[k], rtol=0,
                                       atol=1.5e-3, err_msg=k)


@functools.lru_cache(maxsize=None)
def _swin_trajectory():
    jm = JaxSwinUNETR(num_classes=3, img_size=(TRAJ_SIZE,) * 3,
                      feature_size=12)
    params0 = jax_params(jm, (1, TRAJ_SIZE, TRAJ_SIZE, TRAJ_SIZE, 1), seed=0,
                         train=False)
    # the Flax backbone turns its drop-path rates into Python floats
    with jax.ensure_compile_time_eval(), fast_xla_compile():
        return jax_trajectory(jm, SWIN_TRAIN, TRAJ_SIZE, params0)


def test_swin_unetr_three_step_trajectory_matches_make_train_step(
        monkeypatch):
    """fp32, AdamW + EMA, weights carried by
    ``swin_unetr_state_dict_from_jax``: the step-0 gradients, the losses
    and the params after three steps.  The steps never reach the kernel's
    wrapper: training mode takes the autograd route."""
    def refuse(*args, **kw):
        raise AssertionError("the window-attention kernel in a train step")

    monkeypatch.setattr(swin_layers, "window_attention", refuse)
    model = get_model(config_from_dict(SWIN_TRAIN), device="cpu", train=True)
    assert model.training
    check_trajectory(model, swin_unetr_state_dict_from_jax, SWIN_TRAIN,
                     _swin_trajectory())


def test_window_attention_route_follows_the_mode(monkeypatch):
    """Eval mode calls the kernel's wrapper (once per Swin block), training
    mode ``window_attention_train``; both compute the same values."""
    calls = []
    real = swin_layers.window_attention

    def recorded(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(swin_layers, "window_attention", recorded)
    cfg = config_from_dict(SWIN_TRAIN)
    model = get_model(cfg, device="cpu", train=True,
                      generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 1, 32, 32, 32)).astype(np.float32))
    train_out = model(x)
    assert calls == [] and train_out.requires_grad
    with torch.no_grad():
        eval_out = model.eval()(x)
    assert len(calls) == 6
    torch.testing.assert_close(eval_out, train_out.detach(), rtol=1e-5,
                               atol=1e-5)


def test_the_ema_model_evaluates_through_the_kernel(monkeypatch):
    """Validation evaluates the train state's EMA copy, which stays in eval
    mode: its forward calls the kernel's wrapper, once per Swin block,
    while the live model trains on the autograd route."""
    calls = []
    real = swin_layers.window_attention

    def recorded(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(swin_layers, "window_attention", recorded)
    cfg = config_from_dict(SWIN_TRAIN)
    state = create_train_state(get_model(cfg, device="cpu", train=True), cfg)
    ema = eval_variables(state, True)
    assert ema is state.ema and not ema.training and state.model.training
    with torch.inference_mode():
        ema(torch.zeros(1, 1, 32, 32, 32))
    assert len(calls) == 6


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_train_matches_the_plain_version(masked):
    """The training route's values are the kernel's function, and its
    gradients reach q, k, v and the bias."""
    rng = np.random.default_rng(3)
    B, H, N, D = 4, 2, 49, 8
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, N, D)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    bias = torch.from_numpy(rng.normal(size=(H, N, N)).astype(
        np.float32)).requires_grad_()
    region = (torch.from_numpy(rng.integers(0, 3, size=(2, N)).astype(
        np.int32)) if masked else None)
    out = swin_layers.window_attention_train(q, k, v, bias, region)
    ref = wa.window_attention_plain(q, k, v, bias, region)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    out.square().sum().backward()
    assert all(t.grad is not None and float(t.grad.abs().max()) > 0
               for t in (q, k, v, bias))


def test_drop_path_matches_the_jax_formula_under_a_keep_mask():
    """The JAX DropPath's output fixes its keep mask (x has no zeros);
    the port's formula under that mask gives the same values."""
    p = 0.3
    x = np.random.default_rng(4).uniform(0.5, 1.5, size=(16, 3, 2, 5)
                                         ).astype(np.float32)
    ref = np.asarray(JaxDropPath(p).apply({}, jnp.asarray(x), train=True,
                                          rngs={"dropout":
                                                jax.random.PRNGKey(7)}))
    keep = torch.from_numpy(ref[:, :1, :1, :1] != 0)
    assert 0 < int(keep.sum()) < 16
    out = swin_layers.drop_path(torch.from_numpy(x), p, keep)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)


def test_drop_path_is_the_identity_at_zero_and_in_eval_mode():
    x = torch.randn(4, 3, 5)
    assert swin_layers.DropPath(0.0).train()(x) is x
    assert swin_layers.DropPath(0.5).eval()(x) is x
    with pytest.raises(RuntimeError, match="generator"):
        swin_layers.DropPath(0.5).train()(x)


def test_drop_path_keep_rate_from_a_seeded_generator():
    """One draw a sample: kept samples scaled by 1 / (1 - p), the rest 0,
    at a keep rate near 1 - p, the same masks for the same seed."""
    p, n = 0.25, 4000
    drop = swin_layers.DropPath(p).train()
    x = torch.ones(n, 2, 3)
    outs = []
    for _ in range(2):
        drop.generator = torch.Generator().manual_seed(11)
        outs.append(drop(x))
    assert torch.equal(outs[0], outs[1])
    kept = outs[0][:, 0, 0] != 0
    assert torch.equal(outs[0], (x / (1 - p) * kept[:, None, None]))
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.03


def test_create_train_state_owns_the_drop_path_generator():
    """The train state seeds one generator for the live model's DropPaths
    from ``seed`` (default ``split_seed``); the EMA copy gets none."""
    model = torch.nn.Sequential(torch.nn.Linear(3, 3),
                                swin_layers.DropPath(0.2),
                                swin_layers.DropPath(0.0))
    cfg = config_from_dict(dict(SWIN_TRAIN, split_seed=5))
    state = create_train_state(model, cfg)
    assert state.generator is not None and model[1].generator is \
        state.generator and model[2].generator is None
    assert state.generator.initial_seed() == 5
    assert state.ema[1].generator is None and not state.ema.training
    assert create_train_state(model, cfg, seed=9).generator.initial_seed() \
        == 9
    plain = create_train_state(torch.nn.Linear(3, 3), cfg)
    assert plain.generator is None


def test_get_model_builds_swin_unetr_for_training():
    """The refusal is gone: fp32 parameters in train mode."""
    cfg = config_from_dict(dict(SWIN_TRAIN, amp=True))
    model = get_model(cfg, device="cpu", train=True)
    assert model.training
    assert all(p.dtype == torch.float32 for p in model.parameters())
