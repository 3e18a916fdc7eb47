"""VT-UNet in the PyTorch port vs ``cbim_tpu``'s, on the CPU.

Flax parameters are drawn with numpy from a seed on the tree's shapes, go
through ``vtunet_state_dict_from_jax`` (or the walker's per-block step)
into the port, and both run on the same numpy input: the positional
encoding, the patch ops and the block (self and cross paths), the tiny
model's eval forward, its 3-step trajectory against ``make_train_step``
with ``drop_path_rate`` 0, the reference-layout ``.pth`` the loaders read,
and the prediction CLI.  On the CPU the port's eval-mode window attentions
run the kernel's plain version (the launches are counted where the
wrapper is called), its training-mode ones the autograd route.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models import vtunet as jax_vt
from cbim_tpu.utils import torch_import
from cbim_tpu_torch import prediction
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.nifti import read_nifti, write_nifti
from cbim_tpu_torch.models import get_model, swin_layers, vtunet
from cbim_tpu_torch.ops.kernels import window_attention as wa
from cbim_tpu_torch.training.checkpoint import load_weights
from cbim_tpu_torch.training.train_state import create_train_state
from cbim_tpu_torch.training.trainer import load_pretrained
from cbim_tpu_torch.utils.jax_import import _Walk, vtunet_state_dict_from_jax
from test_torch_swin_train import (TRAJ_SIZE, check_trajectory,
                                   fast_xla_compile, jax_trajectory)
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a VT-UNet at a twelfth of the width (embedding 12: head dim 4), the
#: reference's depths, heads and windows of 7, on 32^3 (an 8^3 token grid:
#: padded windows at stage 0, the window shrunk to (7, 4, 4) at stage 1
#: and below, shifted blocks), with the BCV recipe's training keys and no
#: stochastic depth
TINY = dict(
    dataset="synthetic", model="vtunet", dimension="3d", classes=3,
    in_chan=1, patch_size=[4, 4, 4], embed_dim=12, drop_path_rate=0.0,
    training_size=[32, 32, 32], aux_loss=False, weight=[0.5, 1.0, 1.0],
    rlt=1, optimizer="adamw", base_lr=6e-4, betas=[0.9, 0.999],
    weight_decay=0.05, ema=True, ema_alpha=0.99, split_seed=0)
#: window-attention calls of a forward: 7 encoder blocks, 6 decoder
#: blocks attending twice
ATTENTIONS = 19


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_model(drop_path_rate=0.0):
    return jax_vt.VTUNet(num_classes=3, patch_size=(4, 4, 4), embed_dim=12,
                         drop_path_rate=drop_path_rate)


def _ndhwc_to_port(x):
    return torch.from_numpy(x).movedim(-1, 1).contiguous(
        memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("spatial,channels", [
    ((4, 6, 5), 12), ((2, 3, 3), 96), ((3, 4, 2), 10), ((16, 8, 8), 384)])
def test_positional_encoding_matches_jax(spatial, channels):
    got = vtunet.positional_encoding_3d(spatial, channels)
    np.testing.assert_array_equal(
        got, jax_vt.positional_encoding_3d(spatial, channels))
    assert got.shape == (1, *spatial, channels) and got.dtype == np.float32


def _merging_sd(walk):
    walk.layer_norm(("LayerNorm_0",), "norm")
    walk.dense(("Dense_0",), "reduction", bias=False)


def _expand_sd(walk):
    walk.dense(("Dense_0",), "expand", bias=False)
    walk.layer_norm(("LayerNorm_0",), "norm")


@pytest.mark.parametrize("name", ["merging", "expand", "final"])
def test_patch_ops_match_jax(name):
    """Merging halves H and W only (the four parities in the reference's
    order), expanding doubles them, the final expansion multiplies each
    axis by its patch size: each token's channels land at the same voxel
    as in the JAX ops (one LayerNorm and one matmul apart: fp32 rounding
    only)."""
    C = 8
    jm, port, to_sd = {
        "merging": (jax_vt.PatchMergingHW(), vtunet.PatchMergingHW(C),
                    _merging_sd),
        "expand": (jax_vt.PatchExpandHW(), vtunet.PatchExpandHW(C),
                   _expand_sd),
        "final": (jax_vt.FinalPatchExpand((2, 4, 3)),
                  vtunet.FinalPatchExpand(C, (2, 4, 3)), _expand_sd)}[name]
    x = _x((2, 3, 4, 6, C), 1)
    params = jax_params(jm, x.shape, seed=2)
    walk = _Walk(params)
    to_sd(walk)
    port.load_state_dict(walk.state_dict())
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shift", [(0, 0, 0), (3, 3, 3)])
def test_swin_block_vt_matches_jax(shift):
    """An encoder block, then a decoder block cross-attending to its k and
    v, on a padded (2, 8, 9, 10) grid (windows of 7, batch 2 so the region
    ids wrap at b % nW): both outputs of the port's blocks against the JAX
    blocks', eval mode."""
    C, heads = 12, 3
    x = _x((2, 8, 9, 10, C), 3)
    enc = jax_vt.SwinBlockVT(heads, (7, 7, 7), shift)
    dec = jax_vt.SwinBlockVT(heads, (7, 7, 7), shift)
    p_enc = jax_params(enc, x.shape, seed=4)
    ref_x, v, k, q = enc.apply({"params": p_enc}, jnp.asarray(x))
    y = _x(x.shape, 5)
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(
            lambda key: dec.init({"params": key}, jnp.asarray(y), v, k, q,
                                 is_decoder=True), jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    p_dec = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.normal(0, 0.02 if path[-1].key ==
                                    "relative_position_bias_table" else 0.1,
                                    s.shape)
                         + (1.0 if path[-1].key == "scale" else 0.0)
                         ).astype(np.float32), shapes["params"])
    ref_y, _, _, _ = dec.apply({"params": p_dec}, jnp.asarray(y), v, k, q,
                               is_decoder=True)
    blocks = []
    for params in (p_enc, p_dec):
        walk = _Walk(params)
        walk.swin_block_vt((), "blk")
        block = vtunet.SwinBlockVT(C, heads, (7, 7, 7), shift).eval()
        block.load_state_dict({k[4:]: t for k, t in
                               walk.state_dict().items()})
        blocks.append(block)
    with torch.inference_mode():
        out_x, cache = blocks[0](torch.from_numpy(x))
        out_y, _ = blocks[1](torch.from_numpy(y), cache)
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out_y.numpy(), np.asarray(ref_y), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def tiny_jax():
    """The JAX VT-UNet at TINY's size: its drawn params, an input and the
    eval logits (jitted with XLA's optimisations off)."""
    jm = _jax_model()
    shape = (1, TRAJ_SIZE, TRAJ_SIZE, TRAJ_SIZE, 1)
    params = jax_params(jm, shape, seed=7, train=False)
    x = _x(shape, 8)
    with fast_xla_compile():
        logits = jax.jit(lambda p, t: jm.apply({"params": p}, t,
                                               train=False))(params, x)
    return jm, params, x, np.asarray(logits)


def test_tiny_vtunet_matches_jax(tiny_jax, monkeypatch):
    """The eval forward through the kernel's wrapper, 19 calls (self and
    cross paths), each with q, k, v the kernel can stage (one set of
    strides: the cross path packs its scaled q with the encoder's k and
    v), against the JAX model's logits."""
    _, params, x, ref = tiny_jax
    calls = []

    def recorded(q, k, v, rel_bias, region=None):
        wa._check_kernel_view(q, k, v)
        calls.append(q.shape)
        return wa.window_attention(q, k, v, rel_bias, region)

    monkeypatch.setattr(swin_layers, "window_attention", recorded)
    model = get_model(config_from_dict(TINY), device="cpu")
    model.load_state_dict(vtunet_state_dict_from_jax(params))
    with torch.inference_mode():
        out = model(_ndhwc_to_port(x))
    assert out.dtype == torch.float32 and out.shape == (1, 3, 32, 32, 32)
    assert len(calls) == ATTENTIONS
    # fp32 both sides, the layer norms keep every stage at unit scale
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), ref, rtol=1e-4,
                               atol=1e-4)


def test_state_dict_keys_are_what_import_vtunet_reads(tiny_jax, monkeypatch):
    """The port's state_dict keys, those of the JAX-to-port walk and those
    ``import_vtunet`` reads are one set, and the round trip JAX -> port ->
    ``import_vtunet`` gives the same params back."""
    _, params, _, _ = tiny_jax
    sd = vtunet_state_dict_from_jax(params)
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
    back = torch_import.import_vtunet(sd, zeros)
    assert set(sd) == set(model_keys) == read
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(back_flat) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _vtunet_trajectory():
    jm = _jax_model()
    params0 = jax_params(jm, (1, TRAJ_SIZE, TRAJ_SIZE, TRAJ_SIZE, 1), seed=9,
                         train=False)
    with fast_xla_compile():
        return jax_trajectory(jm, TINY, TRAJ_SIZE, params0)


def test_vtunet_three_step_trajectory_matches_make_train_step(monkeypatch):
    """fp32, AdamW + EMA, drop_path_rate 0, weights carried by
    ``vtunet_state_dict_from_jax``: the step-0 gradients, the losses and
    the params after three steps; no step reaches the kernel's wrapper."""
    def refuse(*args, **kw):
        raise AssertionError("the window-attention kernel in a train step")

    monkeypatch.setattr(swin_layers, "window_attention", refuse)
    model = get_model(config_from_dict(TINY), device="cpu", train=True)
    check_trajectory(model, vtunet_state_dict_from_jax, TINY,
                     _vtunet_trajectory())


def test_drop_path_rates_and_the_train_state_generator():
    """The rates are a linspace up to drop_path_rate over the encoder's
    blocks, the decoder's stage reusing its encoder stage's; the train
    state seeds one generator for them, so a seeded training forward is
    repeatable, and differs from the same weights without DropPath."""
    cfg = config_from_dict(dict(TINY, drop_path_rate=0.1))
    model = get_model(cfg, device="cpu", train=True,
                      generator=torch.Generator().manual_seed(0))
    rates = {n: m.p for n, m in model.named_modules()
             if isinstance(m, swin_layers.DropPath)}
    want = np.linspace(0, 0.1, 7)
    enc = [rates[f"swin_unet.layers.{i}.blocks.{b}.drop_path"]
           for i, d in enumerate(vtunet.DEPTHS) for b in range(d)]
    np.testing.assert_allclose(enc, want, rtol=0, atol=1e-7)
    assert rates["swin_unet.layers_up.1.blocks.1.drop_path"] == \
        pytest.approx(want[5])
    x = torch.from_numpy(_x((2, 1, 32, 32, 32), 10))
    outs = []
    for _ in range(2):
        state = create_train_state(model, cfg, seed=3)
        with torch.no_grad():
            outs.append(model(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with torch.no_grad():
        plain = model.eval()(x)
    assert not torch.allclose(outs[0], plain)
    assert state.ema is not None and not state.ema.training


def test_load_weights_reads_a_reference_layout_pth(tmp_path):
    """A reference VT-UNet checkpoint: its state_dict carries every
    block's ``relative_position_index`` buffer, which the port rebuilds;
    ``load_weights`` (the prediction CLI's ``--load``) and the trainer's
    ``--pretrain`` path (``init_model``) read the rest strictly."""
    cfg = config_from_dict(TINY)
    src = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    sd = dict(src.state_dict())
    for name, m in src.named_modules():
        if isinstance(m, vtunet.WindowAttentionVT):
            sd[f"{name}.relative_position_index"] = \
                m.relative_position_index.clone()
    path = tmp_path / "vtunet_ref.pth"
    torch.save(sd, path)
    model = get_model(cfg, device="cpu")
    load_weights(str(path), model)
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    train_cfg = config_from_dict(dict(TINY, init_model=str(path)))
    state = create_train_state(
        get_model(train_cfg, device="cpu", train=True), train_cfg)
    load_pretrained(train_cfg, state)
    for sd_ in (state.model.state_dict(), state.ema.state_dict()):
        for k, v in src.state_dict().items():
            assert torch.equal(sd_[k], v), k


def test_prediction_main_serves_vtunet_on_the_cpu(tmp_path):
    cfg = config_from_dict(TINY)
    weights = tmp_path / "w.pth"
    torch.save(get_model(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
               .state_dict(), weights)
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    img = _x((20, 40, 36), 11)
    write_nifti(str(in_dir / "case.nii.gz"), img, spacing=(2.0, 1.2, 1.2))
    seconds = prediction.main(
        ["--dataset", "synthetic", "--model", "vtunet", "--dimension", "3d",
         "--load", str(weights), "--img_path", str(in_dir), "--save_path",
         str(out_dir), "--target_spacing", "1.5,1.5,1.5", "--device",
         "cpu"], cfg=cfg)
    assert list(seconds) == ["case.nii.gz"]
    pred = read_nifti(str(out_dir / "case.nii.gz"))
    assert pred.data.shape == img.shape and pred.data.dtype == np.uint8
    assert pred.data.max() < TINY["classes"]


def test_bcv_config_loads_and_matches_the_chip_smoke_recipe():
    """``configs/bcv/vtunet_3d.yaml`` loads through ``load_config`` into
    the full-width model (embedding 96, patch 4, 14 classes, drop-path
    rate 0.1), and ``chip_smoke.py``'s BCV_VT dict carries its model and
    inference keys."""
    pytest.importorskip("yaml")
    from cbim_tpu_torch.config import load_config
    import runpy
    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    cfg = load_config("bcv", "vtunet", "3d")
    for key, value in smoke["BCV_VT"].items():
        assert cfg.get(key) == value, key
    model = get_model(cfg, device="cpu")
    sw = model.swin_unet
    assert sw.patch_embed.proj.out_channels == 96
    assert tuple(sw.patch_embed.proj.kernel_size) == (4, 4, 4)
    assert sw.output.out_channels == 14
    assert sw.layers[3].blocks[0].drop_path.p == pytest.approx(0.1)
