"""SwinUNETR and its Swin layers in the PyTorch port vs ``cbim_tpu``'s, on
the CPU.

Flax parameters are drawn with numpy from a seed on the tree's shapes
(``jax.eval_shape``; the Flax backbone turns its drop-path rates into
Python floats, hence ``ensure_compile_time_eval``), go through
``swin_unetr_state_dict_from_jax`` (or its per-block walks) into the port,
and both forwards run on the same numpy input.  On the CPU the port's
window attentions run the kernel's plain version; the JAX models run their
einsum path, un-jitted.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models import swin_layers as jax_swin
from cbim_tpu.models.swin_unetr import SwinUNETR as JaxSwinUNETR
from cbim_tpu.utils import torch_import
from cbim_tpu_torch import prediction
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.nifti import read_nifti, write_nifti
from cbim_tpu_torch.models import get_model, swin_layers
from cbim_tpu_torch.utils.jax_import import (_Walk,
                                             swin_unetr_state_dict_from_jax)
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX tests' SwinUNETR size (tests/test_transformer_models.py)
TINY = dict(dataset="synthetic", model="swin_unetr", dimension="3d",
            classes=3, in_chan=1, base_chan=12, training_size=[32, 32, 32])


def jax_params(module, x_shape, seed, **call_kw):
    """Flax params of ``module`` drawn with numpy: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2), bias tables
    N(0, 0.02^2)."""
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(
            lambda k, x: module.init({"params": k}, x, **call_kw),
            jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x_shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1 / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "relative_position_bias_table":
            std = 0.02
        else:
            std = 0.1
        v = rng.normal(0.0, std, s.shape)
        return (v + 1.0 if name == "scale" else v).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("spatial,window", [
    ((14, 14, 14), (7, 7, 7)), ((8, 12, 4), (4, 6, 2)), ((6, 8), (3, 4))])
def test_window_partition_and_reverse_match_jax(spatial, window):
    x = _x((2, *spatial, 5), 0)
    wins = swin_layers.window_partition(torch.from_numpy(x), window)
    ref = jax_swin.window_partition(jnp.asarray(x), window)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(ref))
    back = swin_layers.window_reverse(wins, window, spatial)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("window", [(7, 7, 7), (3, 4, 5), (4, 4, 4), (7, 7)])
def test_relative_position_index_matches_jax(window):
    np.testing.assert_array_equal(
        swin_layers.relative_position_index(window),
        jax_swin.relative_position_index(window))


@pytest.mark.parametrize("x_size", [(16, 16, 16), (4, 4, 4), (7, 8, 3)])
def test_get_window_size_matches_jax(x_size):
    for shift in (None, (3, 3, 3)):
        assert swin_layers.get_window_size(x_size, (7, 7, 7), shift) == \
            jax_swin.get_window_size(x_size, (7, 7, 7), shift)


@pytest.mark.parametrize("shift", [(0, 0, 0), (3, 3, 3)])
def test_swin_block_matches_jax(shift):
    """A padded 16^3 input (windows of 7: padded to 21^3, 27 windows) of
    batch 2, so the shifted block's region ids wrap at b % nW."""
    C, heads = 48, 3
    jm = jax_swin.SwinBlock(heads, (7, 7, 7), shift)
    x = _x((2, 16, 16, 16, C), 1)
    params = jax_params(jm, x.shape, seed=2, train=False)
    walk = _Walk(params)
    walk.swin_block((), "blk")
    block = swin_layers.SwinBlock(C, heads, (7, 7, 7), shift)
    block.load_state_dict({k[4:]: v for k, v in walk.state_dict().items()})
    ref = jm.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = block(torch.from_numpy(x))
    # fp32 both sides: sums in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("spatial", [(8, 8, 8), (5, 6, 7)])
def test_patch_merging_legacy_matches_jax(spatial):
    """The duplicate-slice order, and the zero pad of odd extents."""
    C = 12
    jm = jax_swin.PatchMergingLegacy()
    x = _x((2, *spatial, C), 3)
    params = jax_params(jm, x.shape, seed=4)
    walk = _Walk(params)
    walk.patch_merging((), "pm")
    pm = swin_layers.PatchMergingLegacy(C)
    pm.load_state_dict({k[3:]: v for k, v in walk.state_dict().items()})
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        out = pm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def tiny_jax():
    """The JAX SwinUNETR at 32^3, feature size 12: its drawn params, an
    input and the logits."""
    jm = JaxSwinUNETR(num_classes=3, img_size=(32, 32, 32), feature_size=12)
    params = jax_params(jm, (1, 32, 32, 32, 1), seed=5, train=False)
    x = _x((1, 32, 32, 32, 1), 6)
    logits = jm.apply({"params": params}, jnp.asarray(x), train=False)
    return jm, params, x, np.asarray(logits)


def test_tiny_swin_unetr_matches_jax(tiny_jax):
    """32^3 reaches every path: padded windows (16^3 and 8^3 tokens into
    windows of 7), shifted blocks, and the window shrunk to 4^3 at stage 3
    (the bias table's index sliced to [:64, :64])."""
    _, params, x, ref = tiny_jax
    model = get_model(config_from_dict(TINY), device="cpu")
    model.load_state_dict(swin_unetr_state_dict_from_jax(params))
    with torch.inference_mode():
        out = model(torch.from_numpy(x).movedim(-1, 1).contiguous(
            memory_format=torch.channels_last_3d))
    assert out.dtype == torch.float32 and out.shape == (1, 3, 32, 32, 32)
    # fp32 on both sides; the instance and layer norms keep every stage at
    # unit scale, so the logits differ by about 1e-5 of their scale
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), ref, rtol=1e-4,
                               atol=1e-4)


def test_state_dict_keys_are_what_import_swin_unetr_reads(tiny_jax,
                                                          monkeypatch):
    """The port's state_dict keys, those of the JAX-to-port walk and those
    ``import_swin_unetr`` reads are one set, and the round trip JAX ->
    port -> ``import_swin_unetr`` gives the same params back."""
    _, params, _, _ = tiny_jax
    sd = swin_unetr_state_dict_from_jax(params)
    model_keys = get_model(config_from_dict(TINY),
                           device="cpu").state_dict().keys()
    read = set()

    class Recording(dict):
        def __getitem__(self, key):
            read.add(key)
            return super().__getitem__(key)

    to_np = torch_import._to_np
    monkeypatch.setattr(torch_import, "_to_np",
                        lambda state: Recording(to_np(state)))
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    back = torch_import.import_swin_unetr(sd, zeros)
    assert set(sd) == set(model_keys) == read
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(back_flat) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_seeded_weights_draw_the_swin_parameters():
    """init_weights draws the bias tables, the transposed convs and the
    affine instance norms from the generator (not their constant
    defaults), the same for the same seed."""
    cfg = config_from_dict(TINY)
    a, b = (get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()
            for _ in range(2))
    for key in ("swinViT.layers1.0.blocks.0.attn.relative_position_bias_table",
                "decoder1.transp_conv.weight", "encoder1.layer.norm1.weight",
                "encoder1.layer.norm1.bias"):
        assert torch.equal(a[key], b[key]) and a[key].std() > 0, key


def test_get_model_refuses_to_train_swin_unetr(monkeypatch):
    """What is still refused is the kernel in training: ``get_model(train=
    True)`` builds SwinUNETR, and its training-mode forward takes the
    autograd route, never the window-attention kernel's wrapper, which
    has no backward (it once refused to build the model at all; training
    is ported now, ``tests/test_torch_swin_train.py``)."""
    def refuse(*args, **kw):
        raise AssertionError("the window-attention kernel in training")

    monkeypatch.setattr(swin_layers, "window_attention", refuse)
    model = get_model(config_from_dict(TINY), device="cpu", train=True)
    assert model.training
    out = model(torch.zeros(1, 1, 32, 32, 32))
    assert out.shape == (1, 3, 32, 32, 32) and out.requires_grad


def test_prediction_main_serves_swin_unetr_on_the_cpu(tmp_path):
    cfg = config_from_dict(TINY)
    weights = tmp_path / "w.pth"
    torch.save(get_model(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
               .state_dict(), weights)
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    img = _x((20, 40, 36), 7)
    write_nifti(str(in_dir / "case.nii.gz"), img, spacing=(2.0, 1.2, 1.2))
    seconds = prediction.main(
        ["--dataset", "synthetic", "--model", "swin_unetr", "--dimension",
         "3d", "--load", str(weights), "--img_path", str(in_dir),
         "--save_path", str(out_dir), "--target_spacing", "1.5,1.5,1.5",
         "--device", "cpu"], cfg=cfg)
    assert list(seconds) == ["case.nii.gz"]
    pred = read_nifti(str(out_dir / "case.nii.gz"))
    assert pred.data.shape == img.shape and pred.data.dtype == np.uint8
    assert pred.data.max() < TINY["classes"]


def test_bcv_config_loads_and_matches_the_chip_smoke_recipe():
    """``configs/bcv/swin_unetr_3d.yaml`` loads through ``load_config``, and
    ``chip_smoke.py``'s BCV dict (the chip machine has no YAML parser
    guaranteed) carries its model and inference keys."""
    pytest.importorskip("yaml")
    from cbim_tpu_torch.config import load_config
    import runpy
    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    cfg = load_config("bcv", "swin_unetr", "3d")
    for key, value in smoke["BCV"].items():
        assert cfg.get(key) == value, key
    model = get_model(cfg, device="cpu")
    assert model.swinViT.patch_embed.proj.out_channels == 48
    assert model.out.conv.out_channels == 14
