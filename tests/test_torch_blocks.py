"""The conv blocks, norm, activations and resize the port takes since A6c
(``models/layers/convs.py``, ``ops/activations.py``,
``ops/interpolate.py``) vs ``cbim_tpu``'s, on the CPU, block by block.

Each block is built in both packages with the same arguments; its Flax
variables (drawn with numpy, seeded) go into the port through
``utils/jax_import.py``'s ``block_state_dict_from_jax``, which must fill
the port's state_dict exactly (a strict load, as many numbers as the Flax
tree).  The eval forwards run on the same input, the JAX one jitted; its
input gradient too (``jax.vjp``).  Tolerances:

- forwards: BLOCK_TOL, the fp32 forward tolerance of the B-MHA block checks
  (``tests/test_torch_medformer.py``);
- input gradients: both packages' fp32 gradients against an fp64
  evaluation of the port (its plain convs and norms), in relative L2:
  within GRAD_F64_L2 (a wrong tap, flip, norm axis or activation errs by
  O(1); a block's fp32 error is a few 1e-7);
- activations: ACT_TOL (fp32 ulps: the libraries' silu, elu and sigmoid
  round differently);
- ``resize_nearest``: bit-equal, at integer and non-integer ratios.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models.layers import convs as jconvs
from cbim_tpu.ops import interpolate as jinterp
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.ops import activations, interpolate
from cbim_tpu_torch.utils.jax_import import block_state_dict_from_jax
from test_torch_swin_train import fast_xla_compile
from test_torch_unet2d import _instance_norm_f64
from test_torch_threads import few_torch_threads  # noqa: F401

BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_F64_L2 = 1e-5
ACT_TOL = dict(rtol=1e-6, atol=1e-7)

#: every activation the JAX package names beside relu/gelu (prelu: its
#: ReLU placeholder)
NEW_ACTS = ["relu6", "silu", "swish", "lrelu", "sigmoid", "elu", "prelu"]


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def jax_variables(module, x_shape, seed, kernel_gain: float = 1.0):
    """Flax variables of ``module`` for inputs of ``x_shape`` drawn with
    numpy: kernels N(0, kernel_gain^2 / fan_in), norm scales 1 + N(0,
    0.1^2), other params N(0, 0.1^2) (the layer scale too, so that the
    ConvNeXt MLP counts), BatchNorm means N(0, 0.3^2) and variances U(0.5,
    2)."""
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(
            lambda k, x: module.init({"params": k}, x),
            jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x_shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, kernel_gain / np.sqrt(np.prod(s.shape[:-1])),
                           s.shape)
        elif name == "mean":
            v = rng.normal(0.0, 0.3, s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, s.shape)
        else:
            v = rng.normal(0.0, 0.1, s.shape) + (name == "scale")
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


#: the blocks: (name, JAX module, port module, input channels), 3D and 2D;
#: a width change where the block then has a shortcut, InstanceNorm, LN and
#: BatchNorm, fused and unfused activations, MBConv with stochastic depth
#: (eval), ConvNeXt with and without its residual
def _cases():
    cases = []
    for nd, norm in ((3, "in"), (2, "bn")):
        kw = dict(norm=norm, nd=nd)
        cases += [
            (f"Bottleneck-{nd}d", jconvs.Bottleneck(16, norm=norm,
                                                    act="relu"),
             convs.Bottleneck(8, 16, 3, act="relu", **kw), 8),
            (f"Bottleneck-id-{nd}d", jconvs.Bottleneck(8, norm=norm,
                                                       act="silu"),
             convs.Bottleneck(8, 8, 3, act="silu", **kw), 8),
            (f"FusedMBConv-{nd}d", jconvs.FusedMBConv(16, norm="ln",
                                                      act="silu"),
             convs.FusedMBConv(8, 16, 3, norm="ln", act="silu", nd=nd), 8),
            (f"FusedMBConv-1-{nd}d", jconvs.FusedMBConv(
                8, kernel_size=1, norm=norm, act="gelu"),
             convs.FusedMBConv(8, 8, 1, act="gelu", **kw), 8),
            (f"MBConv-p-{nd}d", jconvs.MBConv(16, p=0.2, norm=norm,
                                              act="gelu"),
             convs.MBConv(8, 16, 3, act="gelu", p=0.2, **kw), 8),
            (f"ConvNeXtBlock-{nd}d", jconvs.ConvNeXtBlock(8),
             convs.ConvNeXtBlock(8, 8, nd=nd), 8),
            (f"ConvNeXtBlock-wide-{nd}d", jconvs.ConvNeXtBlock(16),
             convs.ConvNeXtBlock(8, 16, nd=nd), 8),
            (f"SingleConv-ln-elu-{nd}d", jconvs.SingleConv(
                16, norm="ln", act="elu"),
             convs.SingleConv(8, 16, 3, norm="ln", act="elu", nd=nd), 8),
        ]
    cases.append(("SingleConv-in-lrelu-3d", jconvs.SingleConv(
        16, norm="in", act="lrelu"),
        convs.SingleConv(8, 16, 3, norm="in", act="lrelu", nd=3), 8))
    return cases


CASES = _cases()
SPATIAL = {3: (8, 10, 12), 2: (16, 20)}


def _case(name):
    (case,) = [c for c in CASES if c[0] == name]
    _, jm, tm, c_in = case
    nd = 3 if name.endswith("3d") else 2
    return jm, tm, (2, *SPATIAL[nd], c_in), nd


def _fp64_input_grad(tm, x, g):
    """The port's input gradient in fp64: its plain convs (no kernel
    route) and the InstanceNorm as plain torch ops."""
    real = convs.InstanceNormAct
    convs.InstanceNormAct = type("InstanceNormF64", (), {
        "apply": staticmethod(_instance_norm_f64)})
    kernels = {m: m.kernel for m in tm.modules()
               if isinstance(m, convs.ConvNormAct)}
    try:
        for m in kernels:
            m.kernel = None
        tm64 = tm.double()
        xt = torch.from_numpy(x).double().movedim(-1, 1).requires_grad_()
        tm64(xt).backward(torch.from_numpy(g).double().movedim(-1, 1))
        return xt.grad.movedim(1, -1).numpy()
    finally:
        convs.InstanceNormAct = real
        for m, k in kernels.items():
            m.kernel = k
        tm.float()


def _rel_l2(a, ref):
    return float(np.linalg.norm((a - ref).ravel())
                 / np.linalg.norm(ref.ravel()))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_block_matches_jax(name):
    """The eval forward within BLOCK_TOL of the JAX block's, from the same
    Flax variables carried by ``block_state_dict_from_jax`` (strict load,
    every Flax number used once); the input gradients of both against the
    port's fp64 evaluation within GRAD_F64_L2."""
    jm, tm, shape, nd = _case(name)
    variables = jax_variables(jm, shape, seed=1)
    kind = name.split("-")[0]
    sd = block_state_dict_from_jax(
        variables, kind, nd=nd,
        expansion=getattr(jm, "expansion", 4))
    tm.load_state_dict(sd, strict=True)
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(
        variables["params"]))
    assert n_flax == sum(p.numel() for p in tm.parameters())
    tm.eval()

    x, g = _x(shape, 2), None
    with fast_xla_compile():
        y_j, vjp = jax.vjp(jax.jit(lambda t: jm.apply(variables, t)),
                           jnp.asarray(x))
        g = _x(y_j.shape, 3)
        dx_j = np.asarray(jax.jit(vjp)(jnp.asarray(g))[0])
    fmt = convs.CHANNELS_LAST[nd]
    xt = torch.from_numpy(x).movedim(-1, 1).contiguous(
        memory_format=fmt).requires_grad_()
    y = tm(xt)
    np.testing.assert_allclose(y.detach().movedim(1, -1).numpy(),
                               np.asarray(y_j), **BLOCK_TOL)
    y.backward(torch.from_numpy(g).movedim(-1, 1))
    dx = xt.grad.movedim(1, -1).numpy()
    exact = _fp64_input_grad(tm, x, g)
    assert _rel_l2(dx_j, exact) <= GRAD_F64_L2, _rel_l2(dx_j, exact)
    assert _rel_l2(dx, exact) <= GRAD_F64_L2, _rel_l2(dx, exact)


@pytest.mark.parametrize("act", NEW_ACTS)
def test_activation_matches_jax(act):
    """Each activation the JAX package names, elementwise, within
    ACT_TOL; prelu is ReLU in both (JAX's placeholder)."""
    x = np.concatenate([np.linspace(-8, 8, 4097, dtype=np.float32),
                        _x((4096,), 0) * 3])
    ref = np.asarray(jax.jit(jconvs.get_act(act))(jnp.asarray(x)))
    out = activations.get_act(act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **ACT_TOL)
    with pytest.raises(KeyError):
        activations.get_act("mish")


@pytest.mark.parametrize("nd", [3, 2])
def test_layer_norm_matches_flax(nd):
    """``Norm("ln")``: LayerNorm over C with the caller's eps, weight and
    bias; fp32 statistics under bf16 input, bf16 out."""
    shape = (2, *SPATIAL[nd], 12)
    jm = jconvs.Norm("ln", eps=1e-5)
    variables = jax_variables(jm, shape, seed=4)
    x = _x(shape, 5) * 3 + 1
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    norm = convs.Norm("ln", eps=1e-5, channels=12)
    ln = variables["params"]["LayerNorm_0"]
    norm.load_state_dict({"weight": torch.from_numpy(ln["scale"]),
                          "bias": torch.from_numpy(ln["bias"])})
    xt = torch.from_numpy(x).movedim(-1, 1).contiguous(
        memory_format=convs.CHANNELS_LAST[nd])
    with torch.no_grad():
        out, half = norm(xt), norm(xt.bfloat16())
    assert out.is_contiguous(memory_format=convs.CHANNELS_LAST[nd])
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), ref, **BLOCK_TOL)
    assert half.dtype == torch.bfloat16
    np.testing.assert_allclose(half.float().movedim(1, -1).numpy(), ref,
                               rtol=0, atol=3e-2)


@pytest.mark.parametrize("in_shape,out_shape", [
    ((4, 6, 8), (8, 12, 16)), ((4, 6, 8), (2, 3, 4)),
    ((5, 7, 9), (8, 11, 13)), ((9, 11, 7), (4, 6, 5)), ((6, 10), (9, 4))])
def test_resize_nearest_matches_jax(in_shape, out_shape):
    """Nearest-neighbour resize, integer and non-integer ratios, up and
    down: the same source indices as the JAX package's, bit for bit."""
    x = _x((2, *in_shape, 3), 6)
    ref = np.asarray(jinterp.resize_nearest(jnp.asarray(x), out_shape))
    out = interpolate.resize_nearest(torch.from_numpy(x).movedim(-1, 1),
                                     out_shape)
    np.testing.assert_array_equal(out.movedim(1, -1).numpy(), ref)


def _factory_cases():
    from test_torch_medformer import TINY
    from test_torch_medformer2d import TINY2D
    from test_torch_unet2d import ZOO2D
    from test_torch_unet3d import ZOO
    return {"resunet-3d": (dict(ZOO, model="resunet"), "block"),
            "unet++-3d": (dict(ZOO, model="unet++"), "block"),
            "unet-2d": (dict(ZOO2D, model="unet"), "block"),
            "daunet-2d": (dict(ZOO2D, model="daunet"), "block"),
            "medformer-3d": (dict(TINY, attn_drop=0.0, proj_drop=0.0),
                             "conv_block"),
            "medformer-2d": (TINY2D, "conv_block")}


@pytest.mark.parametrize("case", list(_factory_cases()))
def test_both_factories_fail_on_convnext_block(case):
    """ConvNeXtBlock as a model's block: the JAX factory's model fails
    (TypeError: its blocks are passed norm= and act=, which ConvNeXtBlock
    takes not) as soon as it is traced, and the port's factory fails the
    same way, saying why."""
    from cbim_tpu.config import config_from_dict as jax_config
    from cbim_tpu.models import get_model as jax_get_model
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    d, key = _factory_cases()[case]
    d = dict(d, **{key: "ConvNeXtBlock"})
    jm = jax_get_model(jax_config(d))
    shape = (1, 32, 32, 32, 1) if d["dimension"] == "3d" else (1, 64, 64, 1)
    with pytest.raises(TypeError, match="norm"):
        jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                       jax.ShapeDtypeStruct(shape, jnp.float32))
    with pytest.raises(TypeError, match="ConvNeXtBlock takes no"):
        get_model(config_from_dict(d), device="cpu")
