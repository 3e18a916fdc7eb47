"""Whole models with the blocks and options the port takes since A6c, vs
``cbim_tpu``'s, on the CPU: UNet-3D with Bottleneck (InstanceNorm) and
with FusedMBConv (LayerNorm), MedFormer-3D with ``proj_type: linear``,
MBConv conv blocks, SiLU and nonzero dropouts, MedFormer-2D with
``proj_type: linear`` and FusedMBConv conv blocks, and UNet-2D with
Bottleneck (BatchNorm).

Each model's Flax variables are drawn with numpy (seeded: kernels N(0,
1/fan_in), norm scales near 1, BatchNorm statistics away from 0 and 1) and
carried into the port by ``utils/jax_import.py``'s
``state_dict_from_jax``, strictly.  One jitted JAX program per model (with
XLA's optimisations off: ``fast_xla_compile``) gives the eval softmax and
the loss and gradients of one fp32 train-mode step; the port's must agree:

- the eval softmax within PROB_ATOL, the fp32 forward tolerance of the
  zoo's checks (with dropout at p > 0: eval mode draws none);
- the step's loss within 1e-5, and its gradients, and JAX's, against the
  port's fp64 evaluation of the same step (``test_torch_unet2d``'s
  ``check_grads``: JAX's fp32 gradient of these random nets is itself
  ill-conditioned, up to a few 1e-2 in L2 behind stacked norms).

The train steps run with dropout off (p = 0: the two packages' random
streams differ); ``test_torch_dropout.py`` holds the dropout itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.models.medformer import MedFormer3D as JaxMedFormer3D
from cbim_tpu.ops import losses as jax_losses
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.ops import losses
from cbim_tpu_torch.utils.jax_import import state_dict_from_jax
from test_torch_blocks import jax_variables
from test_torch_medformer import TINY
from test_torch_medformer2d import TINY2D
from test_torch_swin_train import fast_xla_compile
from test_torch_unet2d import ZOO2D, _instance_norm_f64, check_grads
from test_torch_unet3d import ZOO
from test_torch_threads import few_torch_threads  # noqa: F401

#: the eval softmax tolerance (fp32 both sides)
PROB_ATOL = 1e-4
#: the training keys the steps read (class weights; deep supervision's
#: head weights where the model has an aux head)
STEP = dict(weight=None, rlt=1, aux_weight=[0.5, 0.5])

#: the kernels' spread: torch's default init's (U(+-1/sqrt(fan_in)), std
#: 1/sqrt(3 fan_in)), as the zoo's checks hold.  Stacked InstanceNorms
#: over few voxels make these random nets ill-conditioned: at N(0,
#: 1/fan_in) and a 2 x 2 x 1 bottom level, JAX's fp32 eval softmax of the
#: Bottleneck ResUNet errs by 1.2e-3 against an fp64 evaluation (the
#: port's by 1.1e-4), at this spread and a 2^3 bottom by 4.2e-4; with the
#: last two levels unpooled (4^3 at the bottom) by 3.7e-5 (the port's by
#: 1.1e-5), which the 1e-4 tolerance holds
KERNEL_GAIN = 3 ** -0.5

#: the models: config, input shape (B, *spatial) of the forwards and the
#: step
MODELS = {
    "unet3d-bottleneck-in": (dict(ZOO, model="resunet", block="Bottleneck",
                                  norm="in", base_chan=8,
                                  down_scale=[[2, 2, 2]] * 2 + [[1, 1, 1]] * 2),
                             (2, 16, 16, 16)),
    "unet3d-fusedmbconv-ln": (dict(ZOO, model="unet", block="FusedMBConv",
                                   norm="ln"), (2, 16, 32, 32)),
    "medformer3d-linear": (dict(TINY, proj_type="linear",
                                conv_block="MBConv", act="silu",
                                attn_drop=0.1, proj_drop=0.1, remat=False),
                           (1, 32, 32, 32)),
    "medformer2d-linear": (dict(TINY2D, proj_type="linear",
                                conv_block="FusedMBConv", attn_drop=0.1,
                                proj_drop=0.1), (2, 64, 64)),
    "unet2d-bottleneck-bn": (dict(ZOO2D, model="unet", block="Bottleneck",
                                  conv2d_kernel=False), (2, 64, 64)),
}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _no_dropout(d):
    return dict(d, attn_drop=0.0, proj_drop=0.0)


def _head0(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def _weights(d):
    return [0.5] + [1.0] * (d["classes"] - 1)


@pytest.fixture(scope="module")
def reference():
    """{model: (variables, eval input, step batch, JAX eval softmax, JAX
    step loss, JAX step gradients)}, computed where first asked for: one
    jitted JAX program per model."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_reference(*MODELS[name])
        return cache[name]

    return get


def _jax_model(d):
    """The JAX model of a config: the factory's, but for MedFormer-3D,
    whose factory takes no ``chan_num`` (its default is the full width)."""
    if d["model"] != "medformer" or d["dimension"] != "3d":
        return jax_get_model(jax_config(d))
    return JaxMedFormer3D(
        num_classes=d["classes"], base_ch=d["base_chan"],
        chan_num=tuple(d["chan_num"]), map_size=tuple(d["map_size"]),
        conv_block=d["conv_block"], conv_num=tuple(d["conv_num"]),
        trans_num=tuple(d["trans_num"]), num_heads=tuple(d["num_heads"]),
        fusion_depth=d["fusion_depth"], fusion_dim=d["fusion_dim"],
        fusion_heads=d["fusion_heads"], expansion=d["expansion"],
        attn_drop=d["attn_drop"], proj_drop=d["proj_drop"],
        proj_type=d["proj_type"], norm=d["norm"], act=d["act"],
        kernel_size=tuple(map(tuple, d["kernel_size"])),
        scale=tuple(map(tuple, d["down_scale"])), aux_loss=d["aux_loss"],
        remat=d["remat"])


def _jax_reference(d, shape):
    jm = _jax_model(d)
    jm_train = _jax_model(_no_dropout(d))
    variables = jax_variables(jm, (*shape, 1), seed=1,
                              kernel_gain=KERNEL_GAIN)
    x, img = _x((*shape, 1), 2), _x((*shape, 1), 3)
    lab = np.random.default_rng(4).integers(0, d["classes"], size=shape
                                            ).astype(np.int32)
    weight = jnp.asarray(_weights(d), jnp.float32)
    heads = 2 if d.get("aux_loss") else 1

    def run(variables, x, img, lab):
        probs = jax.nn.softmax(_head0(jm.apply(variables, x, train=False)),
                               -1)

        def loss_fn(params):
            out, _ = jm_train.apply(dict(variables, params=params), img,
                                    train=True, mutable=["batch_stats"],
                                    rngs={"dropout": jax.random.PRNGKey(0)})
            outs = out if isinstance(out, (list, tuple)) else [out]
            return jax_losses.deep_supervision_loss(
                outs, lab, STEP["aux_weight"][:heads] if heads > 1 else [1.0],
                weight, 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
        return probs, loss, grads

    with fast_xla_compile():
        probs, loss, grads = jax.jit(run)(variables, jnp.asarray(x),
                                          jnp.asarray(img), jnp.asarray(lab))
    return (variables, x, img, lab, np.asarray(probs), float(loss),
            jax.tree.map(np.asarray, grads))


def _port_step(model, d, img, lab):
    """(loss, every parameter's gradient) of one train-mode forward and
    backward of ``model`` (zeros where no output reads a parameter)."""
    out = model(torch.from_numpy(img).movedim(-1, 1).to(
        next(model.parameters()).dtype))
    outs = out if isinstance(out, (list, tuple)) else [out]
    loss = losses.deep_supervision_loss(
        outs, torch.from_numpy(lab).long(),
        STEP["aux_weight"] if len(outs) > 1 else [1.0], _weights(d), 1.0)
    loss.backward()
    return float(loss.detach()), {
        k: (p.grad if p.grad is not None else torch.zeros_like(p))
        for k, p in model.named_parameters()}


def _fp64_step(d, sd, img, lab) -> dict:
    """The port's step gradients in fp64: plain convs (no kernel route),
    the InstanceNorms as plain torch ops."""
    model = get_model(config_from_dict(_no_dropout(d)), device="cpu",
                      train=True)
    model.load_state_dict(sd)
    for m in model.modules():
        if isinstance(m, convs.ConvNormAct):
            m.kernel = None
    model.double()
    real = convs.InstanceNormAct
    convs.InstanceNormAct = type("InstanceNormF64", (), {
        "apply": staticmethod(_instance_norm_f64)})
    try:
        return _port_step(model, d, img.astype(np.float64), lab)[1]
    finally:
        convs.InstanceNormAct = real


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_softmax_matches_jax(name, reference):
    """The eval forward of the full config (dropouts at p > 0 where set)
    from the Flax variables, loaded strictly: softmax within PROB_ATOL."""
    d, _ = MODELS[name]
    variables, x, _, _, probs, _, _ = reference(name)
    cfg = config_from_dict(d)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(cfg, variables))
    with torch.inference_mode():
        out = torch.softmax(_head0(model(torch.from_numpy(x).movedim(-1, 1))),
                            1)
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), probs, rtol=0,
                               atol=PROB_ATOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax(name, reference):
    """One fp32 train-mode step (dropout off) from the same variables: the
    loss within 1e-5 of JAX's, the gradients of both against the port's
    fp64 evaluation (``check_grads``)."""
    d, _ = MODELS[name]
    variables, _, img, lab, _, j_loss, j_grads = reference(name)
    cfg = config_from_dict(_no_dropout(d))
    sd = state_dict_from_jax(cfg, variables)
    model = get_model(cfg, device="cpu", train=True)
    model.load_state_dict(sd)
    loss, grads = _port_step(model, d, img, lab)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    jax_ref = state_dict_from_jax(cfg, dict(variables, params=j_grads))
    check_grads(grads, jax_ref, _fp64_step(d, sd, img, lab))


@pytest.mark.parametrize("name", list(MODELS))
def test_flax_variables_fill_the_port_exactly(name, reference):
    """``state_dict_from_jax`` gives every key of the port's state_dict and
    no other, and the Flax params hold as many numbers as the port's
    parameters."""
    d, _ = MODELS[name]
    variables = reference(name)[0]
    cfg = config_from_dict(d)
    model = get_model(cfg, device="cpu")
    sd = state_dict_from_jax(cfg, variables)
    assert sd.keys() == model.state_dict().keys(), \
        set(sd) ^ set(model.state_dict())
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(
        variables["params"]))
    assert n_flax == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name", ["unet3d-fusedmbconv-ln",
                                  "medformer2d-linear",
                                  "unet3d-bottleneck-in"])
def test_weights_load_through_load_weights(name, reference, tmp_path):
    """A JAX run's Flax ``.ckpt`` of the model (params and BatchNorm
    statistics, no EMA) loads through ``load_weights`` strictly, to
    ``state_dict_from_jax``'s values; the port's own ``.pth`` of it loads
    back under the names the blocks' docstrings give (Bottleneck: the
    reference's conv1/conv2/conv3/shortcut)."""
    from cbim_tpu_torch.training.checkpoint import load_weights
    from test_torch_flax_ckpt import write_jax_checkpoint
    d, _ = MODELS[name]
    variables = reference(name)[0]
    cfg = config_from_dict(d)
    path = tmp_path / "fold_0_best.ckpt"
    # the JAX trainer's optimizer keys (its state is written, not read)
    write_jax_checkpoint(path, dict(d, optimizer="adamw", base_lr=1e-3,
                                    betas=[0.9, 0.999], weight_decay=0.05),
                         variables["params"],
                         batch_stats=variables.get("batch_stats"), ema=False)
    model = get_model(cfg, device="cpu")
    load_weights(str(path), model, prefer_ema=False, cfg=cfg)
    want = state_dict_from_jax(cfg, variables)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    pth = tmp_path / "w.pth"
    torch.save(model.state_dict(), pth)
    again = get_model(cfg, device="cpu")
    load_weights(str(pth), again)
    assert all(torch.equal(v, want[k]) for k, v in again.state_dict().items())
    if "bottleneck" in name:
        assert {"inc.conv2.conv1.conv.weight", "inc.conv2.conv3.conv.weight",
                "down1.conv.1.shortcut.conv.weight"} <= set(want)
