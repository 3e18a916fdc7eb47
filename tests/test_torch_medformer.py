"""MedFormer-3D of the PyTorch port vs ``cbim_tpu``'s, on the CPU.

The Flax model is initialised, its params go through
``medformer3d_state_dict_from_jax`` into the port, and both forwards run on
the same input (numpy, seeded).  On the CPU the port's kernel sites run
their plain versions and the JAX model its XLA path.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.models.medformer import MedFormer3D as JaxMedFormer3D
from cbim_tpu.utils.torch_import import import_medformer3d
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.ops.kernels.conv3d import ConvInormAct3d
from cbim_tpu_torch.utils.jax_import import medformer3d_state_dict_from_jax
from test_torch_threads import few_torch_threads  # noqa: F401

#: a narrow MedFormer-3D with the AMOS recipe's structure: 3^3 kernels,
#: 2^3 downsampling, conv blocks in down1/down2/up2/up3/up4, B-MHA from
#: down2 to up2, aux head
TINY = dict(
    dataset="synthetic", model="medformer", dimension="3d", classes=3,
    in_chan=1, base_chan=8, chan_num=[16, 32, 64, 80, 64, 32, 16, 8],
    map_size=[2, 2, 2], conv_block="BasicBlock",
    conv_num=[2, 1, 0, 0, 0, 1, 2, 2], trans_num=[0, 1, 1, 1, 1, 1, 0, 0],
    num_heads=[1, 4, 4, 4, 4, 4, 1, 1], fusion_depth=2, fusion_dim=64,
    fusion_heads=4, expansion=4, proj_type="depthwise", norm="in",
    act="gelu", kernel_size=[[3, 3, 3]] * 5, down_scale=[[2, 2, 2]] * 4,
    aux_loss=True)

#: the model and inference keys of configs/amos_ct/medformer_3d.yaml
AMOS = dict(
    dataset="amos_ct", model="medformer", dimension="3d", classes=16,
    in_chan=1, base_chan=32, conv_block="BasicBlock",
    down_scale=[[2, 2, 2]] * 4, kernel_size=[[3, 3, 3]] * 5, norm="in",
    act="relu", map_size=[4, 4, 4], conv_num=[2, 1, 0, 0, 0, 1, 2, 2],
    trans_num=[0, 1, 4, 6, 4, 1, 0, 0], num_heads=[1, 4, 8, 10, 8, 4, 1, 1],
    expansion=4, fusion_depth=2, fusion_dim=320, fusion_heads=10,
    attn_drop=0.0, proj_drop=0.0, proj_type="depthwise",
    chan_num=[64, 128, 256, 320, 256, 128, 64, 32], aux_loss=True,
    training_size=[128, 128, 128], sliding_window=True,
    window_size=[128, 128, 128])


def jax_medformer(d):
    return JaxMedFormer3D(
        num_classes=d["classes"], base_ch=d["base_chan"],
        chan_num=tuple(d["chan_num"]), map_size=tuple(d["map_size"]),
        conv_num=tuple(d["conv_num"]), trans_num=tuple(d["trans_num"]),
        num_heads=tuple(d["num_heads"]), fusion_depth=d["fusion_depth"],
        fusion_dim=d["fusion_dim"], fusion_heads=d["fusion_heads"],
        norm=d["norm"], act=d["act"],
        kernel_size=tuple(map(tuple, d["kernel_size"])),
        scale=tuple(map(tuple, d["down_scale"])), aux_loss=d["aux_loss"])


def jax_params(model, shape, seed=0):
    """Flax params as nested dicts of numpy arrays (jit: ~3x faster)."""
    init = jax.jit(lambda k, x: model.init({"params": k}, x, train=False))
    v = init(jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32))
    return jax.tree_util.tree_map(np.asarray, v["params"])


def zero_params(model, shape):
    """The Flax param tree of ``model`` as zeros, without running it."""
    shapes = jax.eval_shape(
        lambda x: model.init({"params": jax.random.PRNGKey(0)}, x,
                             train=False), jax.ShapeDtypeStruct(shape, jnp.float32))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes["params"])


def _check_tiny_forward(d):
    """The port's forward of ``d`` (TINY, or TINY with options) vs the JAX
    model's, with the same weights; returns the port's model."""
    jm = jax_medformer(d)
    params = jax_params(jm, (1, 32, 32, 32, 1))
    cfg = config_from_dict(d)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(medformer3d_state_dict_from_jax(params, cfg))

    x = np.random.default_rng(0).normal(size=(1, 32, 32, 32, 1)).astype(np.float32)
    j_out, j_aux = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))(
        params, jnp.asarray(x))
    with torch.inference_mode():
        t_out, t_aux = model(torch.from_numpy(x).movedim(-1, 1))
    # fp32 on both sides; only the order of sums differs (XLA vs PyTorch's
    # CPU kernels), and every stage's InstanceNorm keeps activations at unit
    # scale, so the differences stay near 1e-5 of the logits' scale
    for t, j in ((t_out, j_out), (t_aux, j_aux)):
        np.testing.assert_allclose(t.movedim(1, -1).numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-4)
    return model


def test_tiny_forward_matches_jax():
    _check_tiny_forward(TINY)


def test_tiny_forward_with_conv_na_matches_jax(monkeypatch):
    """``conv_na``: every conv of the BasicBlocks (a preact InstanceNorm 3^3
    conv) runs as one fused ``ConvInormAct3d``, the counterpart of the JAX
    package's ``CBIM_CONV_NA=1`` route, which computes the same function as
    the unfused chain the JAX model runs on the CPU: the same tolerance."""
    calls = []

    class Counting:
        @staticmethod
        def apply(*args):
            calls.append(1)
            return ConvInormAct3d.apply(*args)

    monkeypatch.setattr(convs, "ConvInormAct3d", Counting)
    model = _check_tiny_forward(dict(TINY, conv_na=True))
    blocks = [m for b in model.modules() if isinstance(b, convs.BasicBlock)
              for m in b.modules() if isinstance(m, convs.ConvNormAct)]
    assert blocks and all(m.fused for m in blocks)
    fused = [m for m in model.modules()
             if isinstance(m, convs.ConvNormAct) and m.fused]
    assert len(fused) == len(blocks) == len(calls)


def test_state_dict_round_trip_through_import_medformer3d():
    # import_medformer3d gives every first decoder conv block a shortcut,
    # so the round trip runs on the config family it maps: no decoder
    # stage with both B-MHA and conv blocks
    d = dict(TINY, conv_num=[2, 1, 0, 0, 0, 0, 2, 2])
    cfg = config_from_dict(d)
    sd = get_model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(3)).state_dict()
    flax = import_medformer3d(sd, zero_params(jax_medformer(d), (1, 32, 32, 32, 1)),
                              d["conv_num"], d["trans_num"], d["num_heads"],
                              d["chan_num"], d["fusion_depth"])
    back = medformer3d_state_dict_from_jax(flax, cfg)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k].contiguous()), k


def test_import_medformer3d_fails_on_amos_layout():
    """ROADMAP fault C6: ``import_medformer3d`` looks for a shortcut conv
    (``ConvNormAct_2``) in every first decoder conv block, but both models
    have one only in a stage without B-MHA blocks, so the TINY (AMOS-layout)
    round trip fails at up2.  When C6 is fixed this test fails: turn it into
    the identity round trip on TINY, as
    ``test_state_dict_round_trip_through_import_medformer3d``."""
    cfg = config_from_dict(TINY)
    sd = get_model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(3)).state_dict()
    assert "up2.conv_blocks.0.shortcut.conv.weight" not in sd
    with pytest.raises(KeyError, match="ConvNormAct_2"):
        import_medformer3d(sd, zero_params(jax_medformer(TINY), (1, 32, 32, 32, 1)),
                           TINY["conv_num"], TINY["trans_num"], TINY["num_heads"],
                           TINY["chan_num"], TINY["fusion_depth"])


def test_full_width_amos_params_match_flax_tree():
    """Every parameter of the full-width AMOS-CT model has its Flax
    counterpart of the same size, and nothing is left over."""
    cfg = config_from_dict(AMOS)
    tree = zero_params(jax_get_model(cfg), (1, 32, 32, 32, 1))
    sd = medformer3d_state_dict_from_jax(tree, cfg)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(sd)           # strict: same names and shapes
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_flax


def test_grouped_conv_weights_stay_contiguous_through_load():
    """Grouped (depthwise) convs run in contiguous memory, every other conv
    weight in channels_last_3d; loading a state_dict keeps both.  Strides
    are compared, not is_contiguous(): a [C, 1, 3, 3, 3] weight passes
    is_contiguous() in either layout."""
    cfg = config_from_dict(TINY)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(
        get_model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(4)).state_dict())
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv3d)]
    assert any(m.groups > 1 for m in convs)
    for m in convs:
        fmt = (torch.contiguous_format if m.groups > 1
               else torch.channels_last_3d)
        want = torch.empty(m.weight.shape, memory_format=fmt).stride()
        assert m.weight.stride() == want, m


def test_get_model_defaults_to_the_card():
    """Device 'cuda' unless the caller asks for the CPU; without a usable
    card the default raises."""
    assert inspect.signature(get_model).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            get_model(config_from_dict(TINY))


def test_get_model_raises_for_unported_models():
    """The whole zoo and every block, norm and option of the JAX factory
    are ported; what the port still refuses is what the JAX factory cannot
    build either: ConvNeXtBlock as a model's block (it takes no norm or
    act), in 2D as in 3D."""
    with pytest.raises(TypeError, match="ConvNeXtBlock takes no"):
        get_model(config_from_dict(dict(TINY, model="unet", dimension="2d",
                                        block="ConvNeXtBlock")), device="cpu")
    with pytest.raises(TypeError, match="ConvNeXtBlock takes no"):
        get_model(config_from_dict(dict(TINY, model="resunet",
                                        block="ConvNeXtBlock", norm="ln")),
                  device="cpu")
