"""VNet in the PyTorch port vs ``cbim_tpu``'s, on the CPU, with the checks
of ``tests/test_torch_unet3d.py``: the keys round-trip through
``import_vnet``, the eval forward (ContBatchNorm: the batch's statistics
in eval mode too; no kernel on its path) and a 2-step trajectory match the
JAX model, the latter with the whole-channel dropout's masks fixed on both
sides (the JAX module's ``nn.Dropout`` replaced in the test, the port's
``ChannelDropout.keep_mask``).  The dropout's rate and channel-wise shape
are checked on their own, a reference state_dict's unused BatchNorm
buffers load, the sliding-window engine groups windows as the JAX engine
does, and the shipped recipe builds.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen

from cbim_tpu.inference.engines import InferenceEngine as JaxEngine
from cbim_tpu.models import vnet as jax_vnet
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.inference import engines
from cbim_tpu_torch.models import get_model, vnet
from cbim_tpu_torch.training.train_state import create_train_state
from cbim_tpu_torch.utils.jax_import import vnet_state_dict_from_jax
from test_torch_unet3d import (FWD_SHAPE, PROB_ATOL, TRAJ_STEPS, ZOO, _x,
                               check_eval_forward, check_round_trip,
                               check_train, port_params_in_jax, template)
from test_torch_threads import few_torch_threads  # noqa: F401

#: a VNet at a quarter of the reference's width (base 4: widths 4-64)
D = dict(ZOO, model="vnet")
#: the dropouts of a forward, in call order: down_tr128, down_tr256,
#: up_tr256 (input, skip), up_tr128 (input, skip), up_tr64 and up_tr32
#: (skips)
DROPOUTS = 8


def _case():
    jm = jax_vnet.VNet(num_classes=3, base_ch=4)

    def to_jax(sd, template):
        return torch_import.import_vnet(sd, template)

    return D, jm, to_jax, vnet_state_dict_from_jax


def test_keys_round_trip_through_import_vnet():
    check_round_trip(*_case())


def test_eval_forward_matches_jax(monkeypatch):
    """Eval mode normalises with the batch's statistics, as JAX's
    ContBatchNorm always does; the 5^3 convs and the norms are cuDNN's and
    torch's: no kernel wrapper is called."""
    got = check_eval_forward(*_case(), monkeypatch)
    assert got == dict(conv3d=0, inorm=0, routed_conv=0, routed_norm=0)


def test_prelu_variant_matches_jax():
    """``elu=False`` (per-channel PReLU, which the factory does not build,
    as in JAX): the slopes round-trip through ``import_vnet(elu=False)``
    and the eval forward matches the JAX model on them."""
    jm = jax_vnet.VNet(num_classes=3, base_ch=4, elu=False)
    model = vnet.VNet(1, 3, base_ch=4, elu=False).eval()
    with torch.no_grad():
        gen = torch.Generator().manual_seed(6)
        for m in model.modules():
            if isinstance(m, torch.nn.PReLU):
                m.weight.uniform_(0.1, 0.4, generator=gen)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = torch_import.import_vnet(sd, template(jm, FWD_SHAPE), elu=False)
    back = vnet_state_dict_from_jax(params)
    assert back.keys() == sd.keys() and any("relu1.weight" in k for k in sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    x = _x((*FWD_SHAPE, 1), 7)
    ref = jax.nn.softmax(jax.jit(jm.apply)({"params": params},
                                           jnp.asarray(x)), -1)
    with torch.inference_mode():
        out = torch.softmax(model(torch.from_numpy(x).movedim(-1, 1)), 1)
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), np.asarray(ref),
                               rtol=0, atol=PROB_ATOL)


def _mask(i, batch, channels):
    """Dropout call i's keep mask (batch, channels), seeded by i."""
    return np.random.default_rng(100 + i).uniform(
        size=(batch, channels)) < 1.0 - vnet.DROP_RATE


def fix_dropout_masks(monkeypatch):
    """Both models' dropouts draw ``_mask`` by call index, modulo a
    forward's DROPOUTS: the JAX module's ``nn.Dropout`` (its jitted step
    traces a forward once) and the port's ``ChannelDropout.keep_mask``."""
    calls = {"jax": 0, "port": 0}

    class FixedDropout:
        def __init__(self, rate, deterministic=False, broadcast_dims=()):
            self.rate, self.deterministic = rate, deterministic
            assert tuple(broadcast_dims) == (1, 2, 3)

        def __call__(self, x):
            if self.deterministic:
                return x
            i = calls["jax"] % DROPOUTS
            calls["jax"] += 1
            keep = _mask(i, x.shape[0], x.shape[-1])[:, None, None, None, :]
            return jnp.where(keep, x / (1.0 - self.rate), 0.0)

    def keep_mask(self, x):
        i = calls["port"] % DROPOUTS
        calls["port"] += 1
        keep = torch.from_numpy(_mask(i, x.shape[0], x.shape[1]))
        return keep[:, :, None, None, None].to(x.device)

    proxy = types.SimpleNamespace(
        **{k: getattr(linen, k) for k in dir(linen) if not k.startswith("_")})
    proxy.Dropout = FixedDropout
    monkeypatch.setattr(jax_vnet, "nn", proxy)
    monkeypatch.setattr(vnet.ChannelDropout, "keep_mask", keep_mask)
    return calls


def test_two_step_trajectory_matches_make_train_step(monkeypatch):
    """Train mode: the same dropout masks on both sides, the batch's
    statistics everywhere."""
    calls = fix_dropout_masks(monkeypatch)
    check_train(*_case())
    assert calls["jax"] == DROPOUTS           # one traced forward
    # the step-0 gradients, then the steps
    assert calls["port"] == (1 + TRAJ_STEPS) * DROPOUTS


def test_channel_dropout_rate_shape_and_formula():
    """Whole channels are kept with probability 1 - p and scaled by 1 / (1
    - p), from the train state's generator; the JAX formula under the same
    keep mask; the identity in eval mode; no generator raises."""
    p = vnet.DROP_RATE
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 1.5, size=(16, 64, 3, 4, 5)).astype(np.float32))
    drop = vnet.ChannelDropout(p).train()
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(1)
    y = drop(x)
    kept = (y != 0).flatten(2)
    assert (kept.all(-1) | ~kept.any(-1)).all()         # whole channels
    share = float(kept.all(-1).float().mean())
    assert abs(share - (1 - p)) < 0.05, share           # 1024 channels
    keep = kept.all(-1)[:, :, None, None, None]
    torch.testing.assert_close(y, torch.where(keep, x / (1 - p), 0.0),
                               rtol=0, atol=0)
    ref = linen.Dropout(p, broadcast_dims=(1, 2, 3)).apply(
        {}, jnp.asarray(x.movedim(1, -1).numpy()), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(3)})
    jkeep = torch.from_numpy(np.asarray(ref)[:, :1, :1, :1, :] != 0)
    out = torch.where(jkeep.movedim(-1, 1), x / (1 - p), 0.0)
    np.testing.assert_array_equal(out.movedim(1, -1).numpy(),
                                  np.asarray(ref))
    assert drop.eval()(x) is x


def test_train_state_seeds_the_dropout():
    """``create_train_state`` gives every ChannelDropout the state's
    generator; the EMA copy evaluates without drawing."""
    cfg = config_from_dict(D)
    model = get_model(cfg, device="cpu", train=True)
    state = create_train_state(model, cfg, seed=7)
    drops = [m for m in model.modules() if isinstance(m, vnet.ChannelDropout)]
    # do1 of down_tr128/256 and up_tr256/128, do2 of the four up blocks
    assert len(drops) == DROPOUTS and all(m.generator is state.generator
                                          for m in drops)
    x = torch.from_numpy(_x((2, 1, 16, 32, 32), 1))
    with torch.no_grad():
        a, b = model(x), model(x)
        e1, e2 = state.ema(x), state.ema(x)
    assert not torch.equal(a, b)
    torch.testing.assert_close(e1, e2, rtol=0, atol=0)


def test_reference_state_dict_with_bn_buffers_loads():
    """The reference's ContBatchNorm is a BatchNorm3d: its state_dict has
    running statistics the forward never reads; they load and are
    dropped, and any other stray key still raises."""
    model = get_model(config_from_dict(D), device="cpu")
    sd = dict(model.state_dict())
    for k in [k for k in sd if k.endswith("bn1.weight")]:
        base = k[:-len("weight")]
        sd[base + "running_mean"] = torch.zeros_like(sd[k])
        sd[base + "running_var"] = torch.ones_like(sd[k])
        sd[base + "num_batches_tracked"] = torch.tensor(5)
    get_model(config_from_dict(D), device="cpu").load_state_dict(sd)
    sd["in_tr.conv1.running_mean"] = torch.zeros(4)
    with pytest.raises(RuntimeError, match="running_mean"):
        get_model(config_from_dict(D), device="cpu").load_state_dict(sd)


def test_sliding_window_groups_windows_as_jax():
    """Three windows at a window batch of 2: the JAX engine pads the second
    group with the first window (weight 0), and a batch-statistics forward
    sees that batch; the port's engine does the same for VNet, so the
    probabilities agree, where the unpadded group would not."""
    _, jm, to_jax, to_sd = _case()
    d = dict(D, window_size=[16, 32, 32])
    params = port_params_in_jax(d, jm, to_jax, 4)
    img = _x((1, 16, 32, 64, 1), 5)
    ref = JaxEngine(lambda v, x: jm.apply(v, x), 3, window_size=(16, 32, 32),
                    window_batch=2, variables={"params": params}
                    ).sliding_window(jnp.asarray(img))
    model = get_model(config_from_dict(d), device="cpu")
    model.load_state_dict(to_sd(params))
    eng = engines.make_engine(model, config_from_dict(d), window_batch=2)
    assert eng.pad_groups
    out = eng.sliding_window(torch.from_numpy(img))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    eng.pad_groups = False
    unpadded = eng.sliding_window(torch.from_numpy(img))
    assert float((unpadded - out).abs().max()) > 1e-2


def test_shipped_recipe_builds():
    """configs/acdc/vnet_3d.yaml: base 16, ELU, 4 classes (its
    ``downsample_scale`` key is not read, as in JAX: pooling by 2)."""
    pytest.importorskip("yaml")
    from cbim_tpu_torch.config import load_config
    cfg = load_config("acdc", "vnet", "3d")
    model = get_model(cfg, device="cpu")
    assert model.in_tr.conv1.out_channels == 16
    assert model.down_tr256.down_conv.out_channels == 256
    assert model.up_tr256.up_conv.out_channels == 128
    assert isinstance(model.in_tr.relu1, torch.nn.ELU)
    assert model.down_tr32.down_conv.stride == (2, 2, 2)
    assert model.out_tr.conv2.out_channels == cfg.classes
    assert model.batch_statistics
