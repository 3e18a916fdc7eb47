"""DAUNet-2D in the PyTorch port vs ``cbim_tpu``'s, on the CPU, with the
2D zoo's checks (``test_torch_unet2d``): the keys through
``import_daunet`` and back (BatchNorm included), and, with the PAM and
CAM gains drawn nonzero (at their initial 0 the attentions feed nothing)
and perturbed BatchNorm statistics, the eval softmax, the step-0
gradients and a 2-step AdamW trajectory against ``make_train_step``.  The
head's three 1x1 convs that feed no output take AdamW's decay as optax
gives it (a zero gradient, not none); PAM and CAM against the JAX
modules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models.daunet import CAM as JaxCAM
from cbim_tpu.models.daunet import DAUNet2D as JaxDAUNet2D
from cbim_tpu.models.daunet import PAM as JaxPAM
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.daunet import CAM, PAM
from cbim_tpu_torch.utils.jax_import import (DAHEAD_HEADS,
                                             daunet_state_dict_from_jax)
from test_torch_unet2d import (ZOO2D, check_eval_forward, check_round_trip,
                               check_train, few_torch_threads,
                               port_variables)  # noqa: F401

D = dict(ZOO2D, model="daunet", block="BasicBlock")
#: the three heads' parameters in the port's names
HEADS = [f"DAModule.{h}.1.{p}" for h in DAHEAD_HEADS
         for p in ("weight", "bias")]


@pytest.fixture(scope="module")
def case():
    jm = JaxDAUNet2D(num_classes=4, base_ch=8, block="BasicBlock")

    def to_jax(sd, tmpl):
        return torch_import.import_daunet(sd, tmpl, block="BasicBlock")

    def to_sd(variables):
        return daunet_state_dict_from_jax(variables, config_from_dict(D))

    return D, jm, to_jax, to_sd


@pytest.fixture(scope="module")
def variables(case):
    v = port_variables(case, 1)
    head = v["params"]["DAHead_0"]
    assert float(head["PAM_0"]["gamma"][0]) > 0.4
    assert float(head["CAM_0"]["gamma"][0]) > 0.4
    return v


def test_keys_round_trip_through_import_daunet(case):
    check_round_trip(case)


def test_eval_forward_matches_jax(case, variables, monkeypatch):
    """The body's 42 ConvNormActs on the 3x3 route (the head's 3x3 convs
    are plain convs, as XLA's in JAX)."""
    got = check_eval_forward(case, variables, monkeypatch)
    assert got == dict(conv2d=42, inorm=0, routed_conv=42, routed_norm=0)


def test_two_step_trajectory_matches_make_train_step(case, variables):
    """AdamW + EMA from nonzero gains; the unused heads: the JAX step's
    zero gradient, so AdamW decays them by (1 - lr wd) a step, exactly as
    optax does (torch's AdamW would skip a parameter without a
    gradient)."""
    state, traj = check_train(case, variables, steps=2)
    d, _, _, to_sd = case
    start = to_sd(variables)
    want = to_sd({"params": traj["params"], "batch_stats": traj["stats"]})
    got = state.model.state_dict()
    decay = (1.0 - D["base_lr"] * D["weight_decay"]) ** 2
    for k in HEADS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), start[k].numpy() * decay,
                                   rtol=1e-6, atol=0, err_msg=k)
        assert not torch.equal(got[k], start[k]), k


@pytest.mark.parametrize("which", ["pam", "cam"])
def test_attention_modules_match_jax(which):
    """PAM (reduction 8) and CAM with gain 0.7 on (2, 16, 5, 6): logits and
    softmax in fp32, the same outputs within 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 6, 16)).astype(np.float32)
    if which == "pam":
        jm = JaxPAM()
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
        p = jax.tree.map(np.array, v["params"])
        p["gamma"] = np.array([0.7], np.float32)
        tm = PAM(16)
        for c, name in enumerate(("query_conv", "key_conv", "value_conv")):
            conv = getattr(tm, name)
            conv.weight.data = torch.from_numpy(
                p[f"Conv_{c}"]["kernel"].transpose(3, 2, 0, 1).copy())
            conv.bias.data = torch.from_numpy(p[f"Conv_{c}"]["bias"])
    else:
        jm = JaxCAM()
        p = {"gamma": np.array([0.7], np.float32)}
        tm = CAM()
    tm.gamma.data = torch.tensor([0.7])
    ref = jm.apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_unused_heads_are_parameters_no_output_reads():
    """The heads exist (the reference's and JAX's trees have them) and get
    no gradient from a forward; the parameter count matches the Flax
    tree's (``check_round_trip``)."""
    model = get_model(config_from_dict(D), device="cpu", train=True)
    model(torch.randn(2, 1, 64, 64)).square().mean().backward()
    none = sorted(k for k, p in model.named_parameters() if p.grad is None)
    assert none == sorted(HEADS)
