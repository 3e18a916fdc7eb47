"""UNet-3D and ResUNet-3D in the PyTorch port vs ``cbim_tpu``'s, on the CPU,
and the checks the 3D zoo's test files share.

The port's seeded default init (torch's, the reference's) is carried into
the Flax tree by the JAX package's importer (``import_unet``) and back by
``unet3d_state_dict_from_jax``: the keys round-trip exactly, the eval
forwards agree on the softmax within 1e-4, and a 2-step trajectory matches
``make_train_step`` (the gradients in relative L2: see GRAD_L2).  On the
CPU the blocks' ConvNormActs run the kernels' plain versions; the wrapper
calls are counted.  (The JAX side runs its plain XLA path, as its own
tests do on the CPU.)  Against an fp64 evaluation of the tiny ResUNet
(``tests/fp64_conditioning.py``), JAX's fp32 softmax errs by 5.9e-5 at
the default init and 1.5e-4 at N(0, 1/fan_in) weights, the port's by
1.5e-5 and 5.5e-5: the comparison is held at the default init.  The
shipped recipes build, and ``chip_smoke.py``'s RESUNET dict carries
configs/amos_ct/resunet_3d.yaml's model keys and the full-width model's
kernel-route counts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models.unet import UNet3D as JaxUNet3D
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.ops.kernels.conv3d import Conv3dSame
from cbim_tpu_torch.ops.kernels.fused_norm import InstanceNormAct
from cbim_tpu_torch.utils.jax_import import unet3d_state_dict_from_jax
from cbim_tpu_torch.ops import losses
from cbim_tpu_torch.training.train_state import (create_train_state,
                                                 eval_variables,
                                                 make_train_step)
from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.training.optim import get_optimizer as jax_get_optimizer
from cbim_tpu.training.train_state import TrainState as JaxTrainState
from cbim_tpu.training.train_state import make_train_step as jax_make_step
from test_torch_swin_train import fast_xla_compile
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the tiny 3D zoo's config: base 4 (widths 4-40), InstanceNorm, 3^3
#: everywhere, pooling by 2, 3 classes, no deep supervision, and the
#: recipes' training keys (AdamW, EMA, class weights)
ZOO = dict(
    dataset="synthetic", dimension="3d", classes=3, in_chan=1, base_chan=4,
    norm="in", block="BasicBlock", down_scale=[[2, 2, 2]] * 4,
    kernel_size=[[3, 3, 3]] * 5, training_size=[32, 32, 32],
    aux_loss=False, weight=[0.5, 1.0, 1.0], rlt=1, optimizer="adamw",
    base_lr=6e-4, betas=[0.9, 0.999], weight_decay=0.05, ema=True,
    ema_alpha=0.99, split_seed=0)
#: the eval forwards' input (B, D, H, W): the bottom level is 1 x 2 x 2
FWD_SHAPE = (2, 16, 32, 32)
#: the trajectories' batches (2^3 at the bottom: fewer voxels there make
#: the fp32 gradient noisier still, see GRAD_L2) and steps
TRAJ_SHAPE, TRAJ_STEPS = (2, 32, 32, 32), 2
#: the softmax tolerance of the eval forwards (fp32 both sides)
PROB_ATOL = 1e-4


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


#: Flax param templates by (module, input shape): tracing the init is
#: most of a small check's time
_TEMPLATES: dict = {}


def template(jm, shape):
    """A Flax params tree of ``jm`` for inputs of ``shape`` (B, *spatial),
    the importers' template."""
    key = (repr(jm), tuple(shape))
    if key not in _TEMPLATES:
        _TEMPLATES[key] = jax_params(jm, (*shape, 1), seed=0)
    return _TEMPLATES[key]


def port_params_in_jax(d, jm, to_jax, seed, shape=FWD_SHAPE):
    """The port's seeded default init carried into a Flax params tree by
    the JAX importer ``to_jax(state_dict, template)``."""
    model = get_model(config_from_dict(d), device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return to_jax(sd, template(jm, shape))


def check_round_trip(d, jm, to_jax, to_sd, shape=FWD_SHAPE):
    """Port state_dict -> ``import_*`` -> ``*_state_dict_from_jax``: the
    same keys and values, and the Flax tree holds as many numbers as the
    port's parameters."""
    model = get_model(config_from_dict(d), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    params = to_jax({k: v.numpy() for k, v in sd.items()},
                    template(jm, shape))
    back = to_sd(params)
    assert back.keys() == sd.keys(), set(back) ^ set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in model.parameters())


def counted_kernels(monkeypatch):
    """Count the wrapper calls of the 3^3 conv and the InstanceNorm(+act)
    kernels (their plain versions on the CPU) of models built after it."""
    calls = {"conv3d": 0, "inorm": 0}

    class Conv(Conv3dSame):
        @classmethod
        def apply(cls, *args):
            calls["conv3d"] += 1
            return super().apply(*args)

    class Norm(InstanceNormAct):
        @classmethod
        def apply(cls, *args):
            calls["inorm"] += 1
            return super().apply(*args)

    monkeypatch.setattr(convs, "Conv3dSame", Conv)
    monkeypatch.setattr(convs, "InstanceNormAct", Norm)
    return calls


def routed(model) -> tuple[int, int]:
    """(ConvNormActs on the 3^3 kernel route, InstanceNorm modules)."""
    n_conv = sum(1 for m in model.modules()
                 if isinstance(m, convs.ConvNormAct)
                 and m.kernel is not None)
    n_norm = sum(1 for m in model.modules()
                 if isinstance(m, convs.Norm) and m.kind == "in")
    return n_conv, n_norm


def check_eval_forward(d, jm, to_jax, to_sd, monkeypatch,
                       shape=FWD_SHAPE) -> dict:
    """The port's eval forward against ``jm``'s on the same params and
    input, softmax within PROB_ATOL; returns the kernel wrapper calls and
    the model's routes (``routed``)."""
    calls = counted_kernels(monkeypatch)
    params = port_params_in_jax(d, jm, to_jax, 1, shape)
    x = _x((*shape, 1), 2)
    ref = jax.nn.softmax(jax.jit(jm.apply)({"params": params},
                                           jnp.asarray(x)), -1)
    model = get_model(config_from_dict(d), device="cpu")
    model.load_state_dict(to_sd(params))
    assert not model.training
    with torch.inference_mode():
        out = torch.softmax(model(torch.from_numpy(x).movedim(-1, 1)), 1)
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), np.asarray(ref),
                               rtol=0, atol=PROB_ATOL)
    conv, norm = routed(model)
    return dict(calls, routed_conv=conv, routed_norm=norm)


#: the trajectories' optimizer: SGD with a momentum (the recipes' AdamW
#: moves an entry by about lr/eps times its gradient below eps = 1e-5 and
#: by lr above, so JAX's fp32 gradient error below makes it jump; SGD
#: moves every entry by lr times its gradient, which the losses and params
#: then read), and its learning rate
TRAJ_OPT = dict(optimizer="sgd", momentum=0.9, base_lr=0.01)

#: the step-0 gradients' tolerances, in relative L2: the whole gradient
#: (``chip_smoke.py``'s STEP_GRAD_L2) and each tensor.  Behind an
#: InstanceNorm a weight's gradient is a difference of large terms (the
#: loss is blind to the weight's scale), and these nets stack up to 42 of
#: them: against a JAX fp64 evaluation of the tiny ResUNet's step-0
#: gradient (``tests/fp64_conditioning.py``), JAX's fp32 gradient errs by
#: up to 6.3e-3 of a tensor's largest entry (the port's by 4.0e-5), so no
#: comparison with it meets the Swin test's 1e-4 per entry.  A wrong tap,
#: flip or layout errs by O(1).  Each tensor's RMS error is held against
#: its RMS plus GRAD_FLOOR of the largest tensor RMS (``chip_smoke.py``'s
#: STEP_GRAD_FLOOR): a conv bias before VNet's batch-statistics norm has a
#: gradient of rounding noise only.
GRAD_L2, GRAD_TENSOR_L2, GRAD_FLOOR = 2e-2, 5e-2, 2e-2
#: the losses after the first step (its lr times that error in every
#: parameter; a wrong update moves them by ~5e-4)
LATER_LOSS_RTOL = 1e-4


def trajectory_batches(shape, classes, seed=0):
    """TRAJ_STEPS fixed (image, label) batches of ``shape`` (B,
    *spatial)."""
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=(*shape, 1)).astype(np.float32)
            for _ in range(TRAJ_STEPS)]
    labs = [rng.integers(0, classes, size=shape).astype(np.int32)
            for _ in range(TRAJ_STEPS)]
    return imgs, labs


def jax_trajectory(jm, d, params0, shape=TRAJ_SHAPE):
    """TRAJ_STEPS fixed batches of ``shape`` through ``make_train_step``
    (fp32, SGD + EMA) from ``params0``: the batches, the step-0 gradients
    (the first step's momentum trace: v = g from zeros), the losses, and
    the params and EMA params after the steps."""
    imgs, labs = trajectory_batches(shape, d["classes"])
    jc = jax_config(d)
    tx = jax_get_optimizer(jc)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params0,
        opt_state=tx.init(params0), batch_stats={},
        ema_params=jax.tree.map(jnp.array, params0), ema_batch_stats={})
    j_step = jax.jit(jax_make_step(jm, tx, jc))
    j_losses, j_grads = [], None
    for img, lab in zip(imgs, labs):
        state, loss = j_step(state, jnp.asarray(img), jnp.asarray(lab),
                             d["base_lr"])
        if j_grads is None:
            j_grads, = [s.trace for s in state.opt_state.inner_state
                        if hasattr(s, "trace")]
            j_grads = jax.tree.map(np.asarray, j_grads)
        j_losses.append(float(loss))
    return (imgs, labs, params0, j_grads, j_losses,
            jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.ema_params))


def check_trajectory(model, to_sd, d, traj):
    """The port's ``model`` (train mode, CPU) against a
    :func:`jax_trajectory`: the step-0 gradients (GRAD_*), the first loss
    to 1e-5 and the later ones to LATER_LOSS_RTOL, and the params and EMA
    params after the steps to 1.5e-3, as ``tests/test_torch_swin_train.py``
    holds them."""
    imgs, labs, params0, j_grads, j_losses, j_params, j_ema = traj
    tc = config_from_dict(d)
    model.load_state_dict(to_sd(params0))
    t_state = create_train_state(model, tc)
    step = make_train_step(model, t_state.optimizer, tc)
    out = model(torch.from_numpy(imgs[0]).movedim(-1, 1))
    losses.deep_supervision_loss([out], torch.from_numpy(labs[0]), [1.0],
                                 d["weight"], 1.0).backward()
    ref = to_sd(j_grads)
    grads = {k: p.grad for k, p in model.named_parameters()}
    l2 = (sum(float((g - ref[k]).square().sum()) for k, g in grads.items())
          / sum(float(r.square().sum()) for r in ref.values())) ** 0.5
    assert l2 <= GRAD_L2, l2
    rms = {k: float(r.norm()) / r.numel() ** 0.5 for k, r in ref.items()}
    top = max(rms.values())
    for k, g in grads.items():
        err = float((g - ref[k]).norm()) / g.numel() ** 0.5
        assert err <= GRAD_TENSOR_L2 * (rms[k] + GRAD_FLOOR * top), \
            (k, err, rms[k])

    t_losses = [float(step(t_state, torch.from_numpy(img),
                           torch.from_numpy(lab), d["base_lr"]))
                for img, lab in zip(imgs, labs)]
    # the first loss is the initial forward's; the later ones carry lr
    # times the step-0 gradients' fp32 error in every parameter
    np.testing.assert_allclose(t_losses[0], j_losses[0], rtol=1e-5)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LATER_LOSS_RTOL)
    assert t_state.step == TRAJ_STEPS
    for sd, want in ((model.state_dict(), to_sd(j_params)),
                     (eval_variables(t_state, True).state_dict(),
                      to_sd(j_ema))):
        for k in sd:
            np.testing.assert_allclose(sd[k].numpy(), want[k], rtol=0,
                                       atol=1.5e-3, err_msg=k)


def check_train(d, jm, to_jax, to_sd, shape=TRAJ_SHAPE):
    """A TRAJ_STEPS fp32 trajectory on batches of ``shape`` from the port's
    default init against ``make_train_step`` (:func:`check_trajectory`),
    TRAJ_OPT's SGD."""
    d = dict(d, **TRAJ_OPT)
    params0 = port_params_in_jax(d, jm, to_jax, 3, shape)
    with fast_xla_compile():
        trajectory = jax_trajectory(jm, d, params0, shape)
    model = get_model(config_from_dict(d), device="cpu", train=True)
    check_trajectory(model, to_sd, d, trajectory)


BLOCKS = {"unet": "SingleConv", "resunet": "BasicBlock"}


def _case(name):
    d = dict(ZOO, model=name, block=BLOCKS[name])
    jm = JaxUNet3D(num_classes=3, base_ch=4, block=d["block"], norm="in")

    def to_jax(sd, template):
        return torch_import.import_unet(sd, template, block=d["block"])

    def to_sd(params):
        return unet3d_state_dict_from_jax({"params": params},
                                          config_from_dict(d))

    return d, jm, to_jax, to_sd


@pytest.mark.parametrize("name", ["unet", "resunet"])
def test_keys_round_trip_through_import_unet(name):
    check_round_trip(*_case(name))


@pytest.mark.parametrize("name", ["unet", "resunet"])
def test_eval_forward_matches_jax(name, monkeypatch):
    """Every ConvNormAct of the tiny nets is on the kernel route (3^3,
    widths <= 72 in and 40 out): one conv and one InstanceNorm wrapper
    call each a forward (the ResUNet's preact, the UNet's post-act)."""
    got = check_eval_forward(*_case(name), monkeypatch)
    n = {"unet": 17, "resunet": 42}[name]
    assert got == dict(conv3d=n, inorm=n, routed_conv=n, routed_norm=n)


@pytest.mark.parametrize("name", ["unet", "resunet"])
def test_two_step_trajectory_matches_make_train_step(name):
    check_train(*_case(name))


def test_basic_block_shortcut_follows_the_width():
    """A ResUNet block has a shortcut conv exactly where its input width
    differs from its output's (the first block of each level), as the
    Flax tree does; the walk reads it from the tree."""
    model = get_model(config_from_dict(dict(ZOO, model="resunet")),
                      device="cpu")
    for name, m in model.named_modules():
        if isinstance(m, convs.BasicBlock):
            has = m.shortcut is not None
            assert has == (m.conv1.conv.in_channels
                           != m.conv1.conv.out_channels), name


UNET_RECIPES = [("acdc", "unet"), ("synthetic", "unet"),
                ("acdc", "resunet"), ("amos_ct", "resunet"),
                ("amos_mr", "resunet"), ("bcv", "resunet"),
                ("kits", "resunet"), ("lits", "resunet")]


@pytest.mark.parametrize("dataset,name", UNET_RECIPES)
def test_shipped_recipes_build(dataset, name):
    """Each shipped UNet/ResUNet yaml builds through ``load_config`` and
    ``get_model`` with its block, widths, pooling scales and first
    kernel (ACDC's anisotropic (1, 3, 3))."""
    pytest.importorskip("yaml")
    from cbim_tpu_torch.config import load_config
    cfg = load_config(dataset, name, "3d")
    model = get_model(cfg, device="cpu")
    assert isinstance(model.inc.conv2, convs.get_block_cls(cfg.block))
    assert model.inc.conv1.out_channels == cfg.base_chan
    assert model.outc.in_channels == cfg.base_chan
    assert model.outc.out_channels == cfg.classes
    assert [model.get_submodule(f"down{i + 1}.conv.0").kernel_size
            for i in range(4)] == [tuple(s) for s in cfg.down_scale]
    assert model.inc.conv1.kernel_size == tuple(cfg.kernel_size[0])


def test_amos_resunet_matches_the_chip_smoke_recipe():
    """configs/amos_ct/resunet_3d.yaml (ResUNet, base 32, BasicBlock,
    InstanceNorm, 3^3, 16 classes, 128^3): ``chip_smoke.py``'s RESUNET dict
    carries its model and inference keys, and the full-width model routes
    RESUNET_CONVS of its ConvNormActs to the 3^3 kernel (C_in <= 192, C_out
    <= 128: 2 in inc, 5 in down1 and down2, 3 in up2, 5 in up3 and up4)
    and RESUNET_NORMS InstanceNorms to the norm kernels."""
    pytest.importorskip("yaml")
    import runpy
    from cbim_tpu_torch.config import load_config
    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    cfg = load_config("amos_ct", "resunet", "3d")
    for key, value in smoke["RESUNET"].items():
        assert cfg.get(key) == value, key
    model = get_model(cfg, device="cpu")
    assert routed(model) == (smoke["RESUNET_CONVS"], smoke["RESUNET_NORMS"])
    per_level = {name: sum(1 for m in getattr(model, name).modules()
                           if isinstance(m, convs.ConvNormAct)
                           and m.kernel is not None)
                 for name in ("inc", "down1", "down2", "down3", "down4",
                              "up1", "up2", "up3", "up4")}
    assert per_level == dict(inc=2, down1=5, down2=5, down3=0, down4=0,
                             up1=0, up2=3, up3=5, up4=5)

