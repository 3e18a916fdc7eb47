"""UNet-2D and ResUNet-2D in the PyTorch port vs ``cbim_tpu``'s, on the
CPU, and the checks the 2D zoo's test files share.

The 2D CNNs take BatchNorm, so every check carries its statistics.  The
port's seeded default init goes into a Flax tree by the JAX package's
importer (``import_unet(dimension="2d")``) and comes back through
``unet2d_state_dict_from_jax``: the keys round-trip exactly, but for
``import_unet``'s BatchNorm (ROADMAP C15: it maps only the convs, so a
reference ``.pth`` imported by JAX keeps fresh norm parameters and
statistics).  The forwards and steps then run from those Flax variables
with every BatchNorm's scale, bias, mean and variance drawn away from 1,
0, 0, 1 (seeded numpy): the eval softmax within 1e-4 of the JAX model's,
the step-0 gradients of both packages against the port's fp64 evaluation
(``check_grads``: JAX's fp32 gradient of these BatchNorm nets errs by up
to 3.3e-2 in relative L2, so the Swin test's 1e-4 per entry cannot hold
against it), and for ResUNet-2D a 2-step trajectory
(AdamW, EMA, the running statistics).  With ``conv2d_kernel`` on, the
blocks' 3x3 convs take the kernel route (its plain version on the CPU):
the wrapper calls are counted.  The JAX side runs its plain XLA path, as
its own tests do.  ``chip_smoke.py``'s ACDC_RESUNET dict carries
configs/acdc/resunet_2d.yaml's model keys and the full-width model's
kernel-route count, and every shipped ACDC 2D yaml builds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.models.unet import UNet2D as JaxUNet2D
from cbim_tpu.ops import losses as jax_losses
from cbim_tpu.training.optim import get_optimizer as jax_get_optimizer
from cbim_tpu.training.train_state import TrainState as JaxTrainState
from cbim_tpu.training.train_state import make_train_step as jax_make_step
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model, init_weights
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.ops import losses
from cbim_tpu_torch.ops.kernels.conv2d import Conv2dSame
from cbim_tpu_torch.ops.kernels.fused_norm import InstanceNormAct
from cbim_tpu_torch.training.train_state import (create_train_state,
                                                 eval_variables,
                                                 make_train_step)
from cbim_tpu_torch.utils.jax_import import unet2d_state_dict_from_jax
from test_torch_swin_train import fast_xla_compile
from test_torch_unet3d import GRAD_FLOOR, GRAD_L2, LATER_LOSS_RTOL
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the tiny 2D zoo's config: base 8 (widths 8-128), 4 classes, the ACDC
#: recipes' training keys (AdamW 5e-4, wd 0.05, EMA, class weights), the
#: 3x3 kernel route on
ZOO2D = dict(
    dataset="synthetic", dimension="2d", classes=4, in_chan=1, base_chan=8,
    training_size=[64, 64], aux_loss=False, weight=[0.5, 1.0, 1.0, 1.0],
    rlt=1, optimizer="adamw", base_lr=5e-4, betas=[0.9, 0.999],
    weight_decay=0.05, ema=True, ema_alpha=0.99, split_seed=0,
    conv2d_kernel=True)
#: the forwards' and steps' batch (B, H, W): 4^2 at the bottom level
SHAPE = (2, 64, 64)
#: the softmax tolerance of the eval forwards (fp32 both sides)
PROB_ATOL = 1e-4


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


#: Flax variable templates by (module, input shape)
_TEMPLATES: dict = {}


def template(jm, shape):
    """Flax variables {"params", "batch_stats"} of ``jm`` for inputs of
    ``shape`` (B, H, W), zeros (shapes only: no compile)."""
    key = (repr(jm), tuple(shape))
    if key not in _TEMPLATES:
        with jax.ensure_compile_time_eval():
            shapes = jax.eval_shape(
                lambda k, x: jm.init({"params": k}, x, train=False),
                jax.random.PRNGKey(0),
                jax.ShapeDtypeStruct((*shape, 1), jnp.float32))
        _TEMPLATES[key] = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    return jax.tree_util.tree_map(np.array, _TEMPLATES[key])


def batch_norms(model) -> dict:
    """{state_dict prefix: module} of every BatchNorm of the port's model."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, convs.Norm) and m.kind == "bn"}


def seeded_state_dict(d, seed, model=None):
    """The port's seeded default init (into ``model`` where given), every
    BatchNorm's weight, bias and running statistics drawn too (the initial
    1, 0, 0, 1 would leave them untested), and DAUNet's attention gains
    U(0.5, 1.5) (at their initial 0 the attentions feed nothing)."""
    model = model or get_model(config_from_dict(d), device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.uniform_(0.5, 1.5, generator=gen)
        for m in batch_norms(model).values():
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.normal_(0.0, 0.2, generator=gen)
            m.running_mean.normal_(0.0, 0.2, generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def perturb_batch_norms(variables, seed):
    """Every Flax BatchNorm's scale 1 + N(0, 0.2^2), bias N(0, 0.2^2), mean
    N(0, 0.3^2) and variance U(0.5, 2), drawn with numpy, in place."""
    rng = np.random.default_rng(seed)

    def walk(tree, kind):
        for k, sub in tree.items():
            if k.startswith("BatchNorm") and isinstance(sub, dict):
                for name, arr in sub.items():
                    if kind == "params":
                        base = 1.0 if name == "scale" else 0.0
                        sub[name] = (base + 0.2 * rng.normal(size=arr.shape)
                                     ).astype(np.float32)
                    elif name == "mean":
                        sub[name] = (0.3 * rng.normal(size=arr.shape)
                                     ).astype(np.float32)
                    else:
                        sub[name] = rng.uniform(0.5, 2.0, arr.shape
                                                ).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, kind)

    walk(variables["params"], "params")
    walk(variables["batch_stats"], "batch_stats")
    return variables


def port_variables(case, seed, shape=SHAPE):
    """The port's seeded init carried into Flax variables by the JAX
    importer, then every BatchNorm perturbed (:func:`perturb_batch_norms`)."""
    d, jm, to_jax, _ = case
    return perturb_batch_norms(
        to_jax(seeded_state_dict(d, seed), template(jm, shape)), seed + 50)


def check_round_trip(case, bn_carried=True, shape=SHAPE):
    """Port state_dict -> ``import_*`` -> ``*_state_dict_from_jax``: the
    same keys and values (BatchNorm's only where the importer carries it),
    and the Flax params hold as many numbers as the port's parameters."""
    d, jm, to_jax, to_sd = case
    model = get_model(config_from_dict(d), device="cpu")
    sd = seeded_state_dict(d, 0, model)
    variables = to_jax(sd, template(jm, shape))
    back = to_sd(variables)
    assert back.keys() == sd.keys(), set(back) ^ set(sd)
    bn = {f"{prefix}.{name}" for prefix in batch_norms(model)
          for name in ("weight", "bias", "running_mean", "running_var")}
    assert bn
    for k, v in sd.items():
        if not bn_carried and k in bn:
            # ROADMAP C15: import_unet leaves the template's values
            assert not np.array_equal(back[k].numpy(), v), k
            continue
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    n_flax = sum(np.size(a) for a in
                 jax.tree_util.tree_leaves(variables["params"]))
    assert n_flax == sum(p.numel() for p in model.parameters())


def counted_kernels(monkeypatch):
    """Count the wrapper calls of the 3x3 conv and the InstanceNorm(+act)
    kernels (their plain versions on the CPU) of models built after it."""
    calls = {"conv2d": 0, "inorm": 0}

    class Conv(Conv2dSame):
        @classmethod
        def apply(cls, *args):
            calls["conv2d"] += 1
            return super().apply(*args)

    class Norm(InstanceNormAct):
        @classmethod
        def apply(cls, *args):
            calls["inorm"] += 1
            return super().apply(*args)

    monkeypatch.setattr(convs, "Conv2dSame", Conv)
    monkeypatch.setattr(convs, "InstanceNormAct", Norm)
    return calls


def routed(model) -> tuple[int, int]:
    """(ConvNormActs on the 3x3 kernel route, InstanceNorm modules)."""
    n_conv = sum(1 for m in model.modules()
                 if isinstance(m, convs.ConvNormAct)
                 and m.kernel is not None)
    n_norm = sum(1 for m in model.modules()
                 if isinstance(m, convs.Norm) and m.kind == "in")
    return n_conv, n_norm


def check_eval_forward(case, variables, monkeypatch, shape=SHAPE,
                       apply=None) -> dict:
    """The port's eval forward against ``jm``'s (``apply``: its jitted
    apply, to share a compile) on the same ``variables`` and input,
    softmax within PROB_ATOL; returns the kernel wrapper calls and the
    model's routes (:func:`routed`)."""
    d, jm, _, to_sd = case
    calls = counted_kernels(monkeypatch)
    x = _x((*shape, 1), 2)
    apply = apply or jax.jit(jm.apply)
    ref = jax.nn.softmax(apply(variables, jnp.asarray(x)), -1)
    model = get_model(config_from_dict(d), device="cpu")
    model.load_state_dict(to_sd(variables))
    with torch.inference_mode():
        out = torch.softmax(model(torch.from_numpy(x).movedim(-1, 1)), 1)
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), np.asarray(ref),
                               rtol=0, atol=PROB_ATOL)
    conv, norm = routed(model)
    return dict(calls, routed_conv=conv, routed_norm=norm)


def batches(steps, shape, classes, seed=0):
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=(*shape, 1)).astype(np.float32)
            for _ in range(steps)]
    labs = [rng.integers(0, classes, size=shape).astype(np.int32)
            for _ in range(steps)]
    return imgs, labs


def jax_trajectory(jm, d, variables0, steps, shape=SHAPE):
    """``steps`` fixed batches through ``make_train_step`` (fp32, the
    config's optimizer, EMA) from ``variables0``: the batches, the step-0
    gradients (from the first step's AdamW moment: mu = (1 - b1) g from
    zeros), the losses, and the params, batch statistics and EMA params
    after the steps."""
    imgs, labs = batches(steps, shape, d["classes"])
    jc = jax_config(d)
    tx = jax_get_optimizer(jc)
    params0, stats0 = variables0["params"], variables0["batch_stats"]
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params0,
        opt_state=tx.init(params0), batch_stats=stats0,
        ema_params=jax.tree.map(jnp.array, params0),
        ema_batch_stats=jax.tree.map(jnp.array, stats0))
    with fast_xla_compile():
        j_step = jax.jit(jax_make_step(jm, tx, jc))
        j_losses, j_grads = [], None
        for img, lab in zip(imgs, labs):
            state, loss = j_step(state, jnp.asarray(img), jnp.asarray(lab),
                                 d["base_lr"])
            if j_grads is None:
                adam, = [s for s in state.opt_state.inner_state
                         if hasattr(s, "mu")]
                j_grads = jax.tree.map(
                    lambda m: np.asarray(m) / (1.0 - d["betas"][0]), adam.mu)
            j_losses.append(float(loss))
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(imgs=imgs, labs=labs, grads=j_grads, losses=j_losses,
                params=host(state.params), stats=host(state.batch_stats),
                ema=host(state.ema_params),
                ema_stats=host(state.ema_batch_stats))


def port_grads(model, img, lab, weight):
    """(loss, every parameter's gradient) of one train-mode forward and
    backward (zeros where no output reads a parameter)."""
    out = model(torch.from_numpy(img).movedim(-1, 1))
    loss = losses.deep_supervision_loss([out], torch.from_numpy(lab), [1.0],
                                        weight, 1.0)
    loss.backward()
    return float(loss.detach()), {
        k: (p.grad if p.grad is not None else torch.zeros_like(p))
        for k, p in model.named_parameters()}


def jax_grads(jm, d, variables, img, lab):
    """(loss, gradients) of ``make_train_step``'s loss (train mode, the
    batch statistics, deep supervision off) at ``variables``: one
    value_and_grad program, which compiles in about half the time of the
    whole step."""
    weight = jnp.asarray(d["weight"], jnp.float32)

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(img), train=True,
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_losses.deep_supervision_loss(
            [out], jnp.asarray(lab), [1.0], weight, float(d["rlt"]))

    with fast_xla_compile():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"])
    return float(loss), jax.tree.map(np.asarray, grads)


#: the fp32 step-0 gradients against the port's fp64 evaluation, in
#: relative L2 over the whole gradient and of each tensor's RMS (+
#: GRAD_FLOOR of the largest).  These random BatchNorm nets' fp32 gradients
#: are ill-conditioned in both packages: against that evaluation JAX's err
#: by up to 3.3e-2 in L2 (DAUNet's step) and the port's by up to 2.8e-2,
#: and a single tensor of either by up to 6.3e-2 of its scale (DAUNet's
#: CAM gain, a scalar); a wrong tap, flip, layout or norm errs by O(1).
#: JAX's: JAX_GRAD_L2 and, for both, GRAD_TENSOR_TOL a tensor
JAX_GRAD_L2, GRAD_TENSOR_TOL = 0.1, 0.25
#: the port's whole fp32 gradient may err against fp64 by GRAD_L2
#: (``test_torch_unet3d``'s) or by this many times JAX's fp32 error where
#: that is larger (``chip_smoke.py``'s F64_ERR_RATIO)
F64_ERR_RATIO = 2.0


def _instance_norm_f64(x, eps, act):
    """The fused norm's function in plain torch ops, any float dtype (its
    kernels' plain versions take fp32 and bf16 only)."""
    dims = tuple(range(1, x.dim() - 1))
    var, mean = torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return {None: y, False: y, "relu": torch.relu(y),
            "gelu": torch.nn.functional.gelu(y)}[act]


def exact_grads(case, variables, img, lab) -> dict:
    """The port's gradients in fp64 (the plain convs: the kernel route
    off; the InstanceNorms in plain torch ops), from ``variables``."""
    d, _, _, to_sd = case
    model = get_model(config_from_dict(dict(d, conv2d_kernel=False)),
                      device="cpu", train=True)
    model.load_state_dict(to_sd(variables))
    model.double()
    real = convs.InstanceNormAct
    convs.InstanceNormAct = type("InstanceNormF64", (), {
        "apply": staticmethod(_instance_norm_f64)})
    try:
        return port_grads(model, img.astype(np.float64), lab,
                          d["weight"])[1]
    finally:
        convs.InstanceNormAct = real


def l2_errors(grads, ref) -> tuple:
    """(the relative L2 error over the whole gradient, {tensor: its RMS
    error over its RMS + GRAD_FLOOR of the largest RMS}), over ``ref``'s
    tensors."""
    keys = list(ref)
    l2 = (sum(float((grads[k].double() - ref[k].double()).square().sum())
              for k in keys)
          / sum(float(ref[k].double().square().sum()) for k in keys)) ** 0.5
    rms = {k: float(ref[k].double().norm()) / ref[k].numel() ** 0.5
           for k in keys}
    top = max(rms.values())
    return l2, {k: float((grads[k].double() - ref[k].double()).norm())
                / ref[k].numel() ** 0.5 / (rms[k] + GRAD_FLOOR * top)
                for k in keys}


def check_grads(grads, jax_ref, exact):
    """The step-0 gradients against the port's fp64 evaluation ``exact``:
    JAX's fp32 ones within JAX_GRAD_L2 (the two packages compute the same
    function), the port's within GRAD_L2 or F64_ERR_RATIO times JAX's fp32
    error, the larger (its fp32 numerics no worse than JAX's), and every
    tensor of both within GRAD_TENSOR_TOL."""
    j_l2, j_tensor = l2_errors(jax_ref, exact)
    l2, per_tensor = l2_errors(grads, exact)
    assert j_l2 <= JAX_GRAD_L2, j_l2
    assert l2 <= max(GRAD_L2, F64_ERR_RATIO * j_l2), (l2, j_l2)
    for errors in (j_tensor, per_tensor):
        worst = max(errors, key=errors.get)
        assert errors[worst] <= GRAD_TENSOR_TOL, (worst, errors[worst])


def check_step_grads(case, variables, shape=SHAPE):
    """One fp32 train-mode step's loss (to 1e-5 of the JAX package's) and
    gradients (:func:`check_grads`), from ``variables``."""
    d, jm, _, to_sd = case
    (img,), (lab,) = batches(1, shape, d["classes"])
    j_loss, j_grads = jax_grads(jm, d, variables, img, lab)
    model = get_model(config_from_dict(d), device="cpu", train=True)
    model.load_state_dict(to_sd(variables))
    loss, grads = port_grads(model, img, lab, d["weight"])
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    check_grads(grads, to_sd({"params": j_grads,
                              "batch_stats": variables["batch_stats"]}),
                exact_grads(case, variables, img, lab))


def check_train(case, variables0, steps, shape=SHAPE):
    """The port in train mode from ``variables0`` against
    :func:`jax_trajectory`: the step-0 gradients (:func:`check_grads`, the
    JAX step's read back from its AdamW moment), then ``steps`` steps of
    ``make_train_step``: the first loss to 1e-5 and the later ones to
    1e-4 or the first-order bound below, and after the steps the params,
    the EMA params and the running
    statistics (which the EMA copies) to 2 lr a step: AdamW's first steps
    move an entry by about lr whatever its gradient's size, so where a
    gradient is fp32 noise the two sides can step apart by 2 lr
    (``tests/test_torch_train2d.py``'s reasoning).  Returns the port's
    state and the JAX trajectory."""
    d, jm, _, to_sd = case
    traj = jax_trajectory(jm, d, variables0, steps, shape)
    tc = config_from_dict(d)
    sd0 = to_sd(variables0)
    img, lab = traj["imgs"][0], traj["labs"][0]
    model = get_model(tc, device="cpu", train=True)
    model.load_state_dict(sd0)
    _, grads = port_grads(model, img, lab, d["weight"])
    check_grads(grads, to_sd({"params": traj["grads"],
                              "batch_stats": variables0["batch_stats"]}),
                exact_grads(case, variables0, img, lab))

    model.load_state_dict(sd0)            # the probe moved the statistics
    model.zero_grad(set_to_none=True)
    state = create_train_state(model, tc)
    step = make_train_step(model, state.optimizer, tc)
    t_losses = [float(step(state, torch.from_numpy(img),
                           torch.from_numpy(lab), d["base_lr"]))
                for img, lab in zip(traj["imgs"], traj["labs"])]
    np.testing.assert_allclose(t_losses[0], traj["losses"][0], rtol=1e-5)
    # a later loss: to LATER_LOSS_RTOL, or to the first-order bound of
    # what the sides' parameters may have stepped apart (2 lr a step in
    # every entry) times the step-0 gradient's L1 norm, the larger
    g1 = sum(float(np.abs(a).sum())
             for a in jax.tree_util.tree_leaves(traj["grads"]))
    for k in range(1, steps):
        tol = max(LATER_LOSS_RTOL * abs(traj["losses"][k]),
                  2 * d["base_lr"] * k * g1)
        assert abs(t_losses[k] - traj["losses"][k]) <= tol, \
            (k, t_losses[k], traj["losses"][k], tol)
    want = to_sd({"params": traj["params"], "batch_stats": traj["stats"]})
    want_ema = to_sd({"params": traj["ema"],
                      "batch_stats": traj["ema_stats"]})
    atol = 2 * d["base_lr"] * steps
    for sd, ref in ((model.state_dict(), want),
                    (eval_variables(state, True).state_dict(), want_ema)):
        for k in sd:
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(),
                                       rtol=0, atol=atol, err_msg=k)
    return state, traj


BLOCKS = {"unet": "SingleConv", "resunet": "BasicBlock"}


def _case(name):
    d = dict(ZOO2D, model=name, block=BLOCKS[name])
    jm = JaxUNet2D(num_classes=4, base_ch=8, block=d["block"])

    def to_jax(sd, tmpl):
        return {"params": torch_import.import_unet(
                    sd, tmpl["params"], block=d["block"], dimension="2d"),
                "batch_stats": tmpl["batch_stats"]}

    def to_sd(variables):
        return unet2d_state_dict_from_jax(variables, config_from_dict(d))

    return d, jm, to_jax, to_sd


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in BLOCKS}


@pytest.fixture(scope="module")
def variables(cases):
    return {name: port_variables(case, 1) for name, case in cases.items()}


@pytest.mark.parametrize("name", ["unet", "resunet"])
def test_keys_round_trip_through_import_unet(name, cases):
    """import_unet carries the convs and conv_ch, not BatchNorm (C15)."""
    check_round_trip(cases[name], bn_carried=False)


@pytest.mark.parametrize("name", ["unet", "resunet"])
def test_eval_forward_matches_jax(name, cases, variables, monkeypatch):
    """Every ConvNormAct of the tiny nets is on the 3x3 route (widths
    <= 128 in and out): one conv wrapper call each a forward; BatchNorm
    takes no kernel."""
    got = check_eval_forward(cases[name], variables[name], monkeypatch)
    n = {"unet": 17, "resunet": 42}[name]
    assert got == dict(conv2d=n, inorm=0, routed_conv=n, routed_norm=0)


def test_unet_step_gradients_match_jax(cases, variables):
    check_step_grads(cases["unet"], variables["unet"])


def test_resunet_two_step_trajectory_matches_make_train_step(cases,
                                                            variables):
    """AdamW, EMA and the BatchNorm statistics over 2 steps."""
    state, traj = check_train(cases["resunet"], variables["resunet"],
                              steps=2)
    assert state.step == 2
    ema = state.ema.state_dict()
    for k, v in state.model.state_dict().items():
        if "running" in k:
            assert torch.equal(ema[k], v), k


ACDC_2D = ["unet", "resunet", "unet++", "attention_unet", "transunet"]


@pytest.mark.parametrize("name", ACDC_2D)
def test_shipped_acdc_recipes_build(name):
    """Each shipped ACDC 2D yaml builds through ``load_config`` and
    ``get_model``: 4 classes, base 32 (TransUNet: the R50-ViT-B/16 at
    256^2, a 16^2 token grid), the 2D modules."""
    pytest.importorskip("yaml")
    from cbim_tpu_torch.config import load_config
    cfg = load_config("acdc", name, "2d")
    model = get_model(cfg, device="cpu")
    assert cfg.classes == 4 and cfg.training_size == [256, 256]
    if name == "transunet":
        # the R50-ViT-B/16: hidden 768, 12 layers of 12 heads, MLP 3072,
        # dropout 0.1, no ConvNormAct (so no kernel route)
        assert model.transformer.embeddings.grid == (16, 16)
        assert model.segmentation_head[0].out_channels == 4
        layers = model.transformer.encoder.layer
        assert len(layers) == 12 and layers[0].attn.heads == 12
        assert layers[0].attn.query.in_features == 768
        assert layers[0].ffn.fc1.out_features == 3072
        assert layers[0].ffn.dropout.p == 0.1
        assert not any(isinstance(m, convs.ConvNormAct)
                       for m in model.modules())
        return
    head = model.output if name == "unet++" else model.outc
    assert isinstance(head, torch.nn.Conv2d) and head.out_channels == 4
    assert head.in_channels == cfg.base_chan == 32
    if name in ("unet", "resunet"):
        assert isinstance(model.inc.conv2,
                          convs.get_block_cls(cfg.block))


def test_acdc_resunet_matches_the_chip_smoke_recipe():
    """configs/acdc/resunet_2d.yaml (ResUNet-2D, base 32, BasicBlock,
    BatchNorm, 4 classes, 256^2): ``chip_smoke.py``'s ACDC_RESUNET dict
    carries its model keys, and with ``conv2d_kernel`` the full-width
    model routes ACDC_RESUNET_CONVS ConvNormActs to the 3x3 kernel (C_in
    <= 192, C_out <= 192: 2 in inc, 5 in down1 and down2 (a block's 3x3
    shortcut where the width changes), 3 in up2 (its first block's conv1
    and shortcut read the 256-wide concat), 5 in up3 and up4)."""
    pytest.importorskip("yaml")
    import runpy
    from cbim_tpu_torch.config import load_config
    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    cfg = load_config("acdc", "resunet", "2d")
    for key, value in smoke["ACDC_RESUNET"].items():
        if key != "conv2d_kernel":
            assert cfg.get(key) == value, key
    cfg.conv2d_kernel = True
    model = get_model(cfg, device="cpu")
    assert routed(model) == (smoke["ACDC_RESUNET_CONVS"], 0)
    per_level = {name: sum(1 for m in getattr(model, name).modules()
                           if isinstance(m, convs.ConvNormAct)
                           and m.kernel is not None)
                 for name in ("inc", "down1", "down2", "down3", "down4",
                              "up1", "up2", "up3", "up4")}
    assert per_level == dict(inc=2, down1=5, down2=5, down3=0, down4=0,
                             up1=0, up2=3, up3=5, up4=5)


def test_convnormact_block_walks_as_single_conv(cases):
    """``block: ConvNormAct`` (the JAX config's default, an alias of
    SingleConv there and in the port) maps the same Flax tree onto the
    same keys, in 2D and 3D; an unported block raises the ROADMAP error."""
    from cbim_tpu_torch.utils.jax_import import (state_dict_from_jax,
                                                 unet3d_state_dict_from_jax)
    d, jm, _, _ = cases["unet"]
    tmpl = template(jm, SHAPE)
    single = unet2d_state_dict_from_jax(tmpl, config_from_dict(d))
    alias = unet2d_state_dict_from_jax(
        tmpl, config_from_dict(dict(d, block="ConvNormAct")))
    assert alias.keys() == single.keys() == get_model(
        config_from_dict(dict(d, block="ConvNormAct")),
        device="cpu").state_dict().keys()
    from cbim_tpu.models.unet import UNet3D as JaxUNet3D
    d3 = dict(d, dimension="3d", model="unet", block="ConvNormAct",
              norm="in", down_scale=[[2, 2, 2]] * 4,
              kernel_size=[[3, 3, 3]] * 5)
    t3 = template(JaxUNet3D(num_classes=4, base_ch=8, block="SingleConv",
                            norm="in"), (1, 16, 16, 16))
    assert unet3d_state_dict_from_jax(t3, config_from_dict(d3)).keys() == \
        get_model(config_from_dict(d3), device="cpu").state_dict().keys()
    with pytest.raises(NotImplementedError, match="ConvNeXtBlock"):
        state_dict_from_jax(config_from_dict(dict(d, block="ConvNeXtBlock")),
                            tmpl)
