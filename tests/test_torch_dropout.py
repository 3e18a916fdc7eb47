"""Dropout and stochastic depth in the port (``layers/convs.py``
``Dropout``, ``DropPath``) vs ``cbim_tpu``'s, on the CPU, and where the
port's MedFormer draws them.

- Under a given keep mask the port's formulas equal Flax's
  ``nn.Dropout`` and the JAX ``DropPath`` bit for bit (the mask read back
  from the JAX output).
- In train mode the keep rate lies within KEEP_SIGMAS binomial standard
  deviations of 1 - p, kept values are x / (1 - p) exactly and the rest 0;
  eval mode and p = 0 are the identity.
- MedFormer draws ``attn_drop`` on the map-to-feature attention only and
  ``proj_drop`` on the feature output (where the JAX package does), none in
  the map fusion's transformer; in 2D ``proj_drop`` is also the MBConv
  feed-forward's stochastic depth, and under ``proj_type: linear`` the
  FusedMBConv feed-forward has none.
- Every stochastic module draws from the train state's generator: the same
  seed gives the same train step, another seed another; MedFormer-3D's
  remat recompute draws the forward's masks again (the step equals the
  step without remat).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen

from cbim_tpu.models.layers.convs import DropPath as JaxDropPath
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.models.layers.transformers import Attention, Mlp
from cbim_tpu_torch.training.train_state import (create_train_state,
                                                 make_train_step)
from test_torch_medformer import TINY
from test_torch_medformer2d import TINY2D
from test_torch_threads import few_torch_threads  # noqa: F401

#: the keep rate's tolerance in binomial standard deviations
KEEP_SIGMAS = 5.0

DROPPED = dict(TINY, attn_drop=0.2, proj_drop=0.1, remat=False)
TRAIN_KEYS = dict(aux_weight=[0.5, 0.5], weight=[0.5, 1.0, 1.0], rlt=1,
                  optimizer="adamw", base_lr=1e-3, betas=[0.9, 0.999],
                  weight_decay=0.05, ema=False)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_formula_matches_flax(p):
    x = _x((4, 8, 16), 0)
    ref = np.asarray(linen.Dropout(p).apply(
        {}, jnp.asarray(x), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(3)}))
    keep = torch.from_numpy(ref != 0)
    drop = convs.Dropout(p).train()
    drop.keep_mask = lambda t: keep
    out = drop(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_drop_path_formula_matches_jax():
    x = _x((64, 3, 4, 5), 1)
    p = 0.3
    ref = np.asarray(JaxDropPath(p).apply(
        {}, jnp.asarray(x), train=True,
        rngs={"dropout": jax.random.PRNGKey(1)}))
    keep = torch.from_numpy((ref != 0).any(axis=(1, 2, 3))).view(-1, 1, 1, 1)
    out = convs.drop_path(torch.from_numpy(x), p, keep).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("module,n", [("Dropout", 200_000),
                                      ("DropPath", 20_000)])
@pytest.mark.parametrize("p", [0.1, 0.4])
def test_train_mode_keep_rate_and_scale(module, n, p):
    """``n`` draws (elements, or samples for DropPath): the keep rate
    within KEEP_SIGMAS binomial deviations of 1 - p; every kept value x /
    (1 - p) exactly, every other 0; eval mode the identity."""
    m = getattr(convs, module)(p).train()
    m.generator = torch.Generator().manual_seed(0)
    shape = (n,) if module == "Dropout" else (n, 3)
    x = torch.from_numpy(np.abs(_x(shape, 2)) + 0.5)
    y = m(x)
    kept = y != 0
    rate = float(kept.float().mean())
    sigma = math.sqrt(p * (1 - p) / n)
    assert abs(rate - (1 - p)) <= KEEP_SIGMAS * sigma, (rate, 1 - p, sigma)
    torch.testing.assert_close(y[kept], (x / (1 - p))[kept], rtol=0,
                               atol=0)
    if module == "DropPath":
        assert torch.equal(kept.all(1), kept.any(1))   # whole samples
    assert torch.equal(m.eval()(x), x)
    assert torch.equal(getattr(convs, module)(0.0).train()(x), x)


def _draws(model, x):
    """{(module name, input shape)} of the Dropout draws of one train-mode
    forward."""
    seen = []
    names = {m: n for n, m in model.named_modules()}
    real = convs.Dropout.keep_mask

    def keep_mask(self, t):
        seen.append((names[self], tuple(t.shape)))
        return real(self, t)

    convs.Dropout.keep_mask = keep_mask
    try:
        model(x)
    finally:
        convs.Dropout.keep_mask = real
    return seen


def test_medformer_draws_where_jax_does():
    """attn_drop on the (B, heads, N, M) map-to-feature attention of every
    B-MHA block with a map output, proj_drop on its (B, out, *spatial)
    feature output; the map fusion's Attention and Mlp draw nothing."""
    cfg = config_from_dict(DROPPED)
    model = get_model(cfg, device="cpu", train=True)
    create_train_state(model, config_from_dict(dict(DROPPED, **TRAIN_KEYS)))
    draws = _draws(model, torch.zeros(1, 1, 32, 32, 32))
    blocks = [n for n, m in model.named_modules()
              if type(m).__name__ == "BidirectionAttention"]
    with_map = [n for n in blocks
                if model.get_submodule(n).map_out is not None]
    assert sorted(n for n, _ in draws if n.endswith("attn_drop")) == \
        sorted(f"{n}.attn_drop" for n in with_map)
    assert sorted(n for n, _ in draws if n.endswith("proj_drop")) == \
        sorted(f"{n}.proj_drop" for n in blocks)
    for name, shape in draws:
        heads = model.get_submodule(name.rsplit(".", 1)[0]).heads
        if name.endswith("attn_drop"):
            assert len(shape) == 4 and shape[1] == heads, (name, shape)
        else:
            assert len(shape) == 5, (name, shape)
    assert all(m.p == 0 for m in model.map_fusion.modules()
               if isinstance(m, (convs.Dropout, convs.DropPath)))
    assert any(isinstance(m, (Attention, Mlp))
               for m in model.map_fusion.modules())


@pytest.mark.parametrize("proj_type", ["depthwise", "linear"])
def test_medformer2d_feedforward_drop_path(proj_type):
    """2D: proj_drop is the MBConv feed-forward's stochastic depth (JAX's
    ``ffn_drop_path``); the linear FusedMBConv feed-forward has none, and
    3D none either."""
    d2 = dict(TINY2D, proj_drop=0.1, proj_type=proj_type)
    m2 = get_model(config_from_dict(d2), device="cpu")
    ffn = [m for n, m in m2.named_modules() if n.endswith("feedforward")]
    assert ffn and all(
        m.drop_path.p == (0.1 if proj_type == "depthwise" else 0.0)
        and isinstance(m, convs.MBConv if proj_type == "depthwise"
                       else convs.FusedMBConv) for m in ffn)
    m3 = get_model(config_from_dict(dict(TINY, proj_drop=0.1,
                                         proj_type=proj_type)), device="cpu")
    assert all(m.drop_path.p == 0.0 for n, m in m3.named_modules()
               if n.endswith("feedforward"))


def _one_step(seed, sd):
    cfg = config_from_dict(dict(DROPPED, **TRAIN_KEYS))
    model = get_model(cfg, device="cpu", train=True)
    model.load_state_dict(sd)
    state = create_train_state(model, cfg, seed=seed)
    gen = torch.Generator().manual_seed(9)
    img = torch.randn(1, 32, 32, 32, 1, generator=gen)
    lab = torch.randint(0, 3, (1, 32, 32, 32), generator=gen)
    loss = float(make_train_step(model, state.optimizer, cfg)(
        state, img, lab, 1e-3))
    return loss, model.state_dict()


def test_same_seed_same_step():
    """Every Dropout of the model shares the state's generator; two train
    steps from the same weights and seed are equal, bit for bit, and a
    third with another seed differs."""
    cfg = config_from_dict(dict(DROPPED, **TRAIN_KEYS))
    model = get_model(cfg, device="cpu", train=True,
                      generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, seed=5)
    drops = [m for m in model.modules() if isinstance(m, convs.Dropout)
             and m.p]
    assert drops and all(m.generator is state.generator for m in drops)
    sd = model.state_dict()
    (l1, s1), (l2, s2), (l3, _) = (_one_step(s, sd) for s in (5, 5, 6))
    assert l1 == l2 and l1 != l3
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


def test_remat_recompute_draws_the_forward_masks():
    """MedFormer-3D's remat recomputes each stage in the backward pass;
    its dropout draws there are the forward's (the generator rewound, then
    put back), so the step's loss and gradients equal those without remat
    from the same seed, and the generator ends where it would have."""
    cfg = config_from_dict(dict(DROPPED, **TRAIN_KEYS))
    sd = get_model(cfg, device="cpu", train=True,
                   generator=torch.Generator().manual_seed(1)).state_dict()
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 1, 32, 32, 32, generator=gen)
    out = {}
    for remat in (False, True):
        model = get_model(config_from_dict(dict(DROPPED, remat=remat)),
                          device="cpu", train=True)
        model.load_state_dict(sd)
        state = create_train_state(model, cfg, seed=3)
        y = model(x)
        (y[0].square().mean() + y[1].abs().mean()).backward()
        out[remat] = ({k: p.grad for k, p in model.named_parameters()},
                      state.generator.get_state())
    grads, after = out[False]
    r_grads, r_after = out[True]
    assert torch.equal(after, r_after)
    for k, g in grads.items():
        torch.testing.assert_close(r_grads[k], g, rtol=1e-5, atol=1e-7,
                                   msg=k)
