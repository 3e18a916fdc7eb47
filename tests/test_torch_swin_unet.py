"""SwinUnet-2D in the PyTorch port vs ``cbim_tpu``'s, on the CPU.

Flax parameters are drawn with numpy from a seed on the tree's shapes, go
through ``swinunet_state_dict_from_jax`` (or the walker's steps) into the
port, and both run on the same numpy input: both patch mergings (2D, and
``PatchMergingV2`` in 2D and 3D), the expands, a 2D Swin block, the tiny
model's eval forward, the key round trip through ``import_swinunet``, a
3-step trajectory against ``make_train_step`` with ``drop_path_rate`` 0,
DropPath's rates, and a request served by both prediction CLIs.  On the
CPU the port's eval-mode window attentions run the kernel's plain version
(the launches are counted where the wrapper is called), its training-mode
ones the autograd route.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models import swin_layers as jax_swin
from cbim_tpu.models import swin_unet as jax_su
from cbim_tpu.utils import torch_import
from cbim_tpu_torch import prediction
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.nifti import read_nifti, write_nifti
from cbim_tpu_torch.models import get_model, swin_layers, swin_unet
from cbim_tpu_torch.ops.kernels import window_attention as wa
from cbim_tpu_torch.training.train_state import create_train_state
from cbim_tpu_torch.utils.jax_import import (_Walk,
                                             swinunet_state_dict_from_jax)
from test_torch_swin_train import (check_trajectory, fast_xla_compile,
                                   jax_trajectory)
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the 2D crop of the tiny model: a 16^2 token grid (shifted windows of 7
#: padded to 21^2 at stage 0 and 14^2 at stage 1, windows shrunk to 4 and
#: 2 with no shift below)
SIZE = 64
#: a SwinUnet at an eighth of the width (embedding 12: head dim 4), the
#: reference's depths, heads and windows, with the ACDC recipe's training
#: keys and no stochastic depth
TINY = dict(
    dataset="synthetic", model="swinunet", dimension="2d", classes=4,
    in_chan=1, embed_dim=12, drop_path_rate=0.0, training_size=[SIZE, SIZE],
    aux_loss=False, weight=[0.5, 1.0, 1.0, 1.0], rlt=1, optimizer="adamw",
    base_lr=5e-4, betas=[0.9, 0.999], weight_decay=0.05, ema=True,
    ema_alpha=0.99, split_seed=0)
#: window-attention calls of a forward: 12 encoder blocks, 10 decoder
ATTENTIONS = 22
FC = ("fc1", "fc2")


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_model(drop_path_rate=0.0):
    return jax_su.SwinUnet2D(num_classes=4, embed_dim=12,
                             drop_path_rate=drop_path_rate)


def _nhwc_to_port(x):
    return torch.from_numpy(x).movedim(-1, 1).contiguous(
        memory_format=torch.channels_last)


def _merging_sd(walk):
    walk.patch_merging((), "pm")
    return {k[3:]: v for k, v in walk.state_dict().items()}


@pytest.mark.parametrize("kind,spatial", [
    ("legacy", (8, 8)), ("legacy", (5, 7)), ("v2", (8, 8)), ("v2", (5, 7)),
    ("v2", (4, 6, 5))])
def test_patch_merging_matches_jax(kind, spatial):
    """``PatchMergingLegacy``'s 2D branch (the reference's (h, w) order)
    and ``PatchMergingV2`` in 2D and 3D, odd extents zero-padded."""
    C = 6
    nd = len(spatial)
    jm = (jax_swin.PatchMergingLegacy() if kind == "legacy"
          else jax_swin.PatchMergingV2())
    cls = (swin_layers.PatchMergingLegacy if kind == "legacy"
           else swin_layers.PatchMergingV2)
    x = _x((2, *spatial, C), 1)
    params = jax_params(jm, x.shape, seed=2)
    pm = cls(C, spatial_dims=nd)
    pm.load_state_dict(_merging_sd(_Walk(params)))
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        out = pm(torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["expand", "final"])
def test_patch_expands_match_jax(name):
    C = 8
    jm, port = {"expand": (jax_su.PatchExpand2D(), swin_unet.PatchExpand2D(C)),
                "final": (jax_su.FinalPatchExpandX4(),
                          swin_unet.FinalPatchExpandX4(C))}[name]
    x = _x((2, 3, 5, C), 3)
    params = jax_params(jm, x.shape, seed=4)
    walk = _Walk(params)
    walk.dense(("Dense_0",), "expand", bias=False)
    walk.layer_norm(("LayerNorm_0",), "norm")
    port.load_state_dict(walk.state_dict())
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spatial", [(16, 16), (8, 9)])
def test_swin_block_2d_matches_jax(spatial):
    """A shifted 2D block with the vendored names (``mlp.fc1``/``fc2``),
    windows of 7, padded grids, batch 2 so the 2D region ids wrap at b %
    nW (the tiny model's forward holds the unshifted blocks)."""
    shift = (3, 3)
    C, heads = 12, 3
    jm = jax_swin.SwinBlock(heads, (7, 7), shift)
    x = _x((2, *spatial, C), 5)
    params = jax_params(jm, x.shape, seed=6, train=False)
    walk = _Walk(params)
    walk.swin_block((), "blk", mlp=FC)
    block = swin_layers.SwinBlock(C, heads, (7, 7), shift,
                                  mlp=swin_layers.SwinMlp).eval()
    block.load_state_dict({k[4:]: v for k, v in walk.state_dict().items()})
    ref = jm.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = block(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def tiny_jax():
    """The JAX SwinUnet at TINY's size: its drawn params, a one-channel
    input and the eval logits (jitted with XLA's optimisations off)."""
    jm = _jax_model()
    shape = (2, SIZE, SIZE, 1)
    params = jax_params(jm, shape, seed=7, train=False)
    x = _x(shape, 8)
    with fast_xla_compile():
        logits = jax.jit(lambda p, t: jm.apply({"params": p}, t,
                                               train=False))(params, x)
    return jm, params, x, np.asarray(logits)


def test_tiny_swinunet_matches_jax(tiny_jax, monkeypatch):
    """The eval forward through the kernel's wrapper, 22 calls, each with
    q, k, v the kernel can stage, the one channel tiled to three, against
    the JAX model's softmax within 1e-4."""
    _, params, x, ref = tiny_jax
    calls = []

    def recorded(q, k, v, rel_bias, region=None):
        wa._check_kernel_view(q, k, v)
        calls.append((q.shape, region is not None))
        return wa.window_attention(q, k, v, rel_bias, region)

    monkeypatch.setattr(swin_layers, "window_attention", recorded)
    model = get_model(config_from_dict(TINY), device="cpu")
    model.load_state_dict(swinunet_state_dict_from_jax(params))
    with torch.inference_mode():
        out = model(_nhwc_to_port(x))
    assert out.dtype == torch.float32 and out.shape == (2, 4, SIZE, SIZE)
    assert len(calls) == ATTENTIONS
    assert {c[0][2] for c in calls} == {49, 16, 4}
    # shifted blocks at stages 0 and 1, encoder and decoder
    assert sum(masked for _, masked in calls) == 4
    np.testing.assert_allclose(torch.softmax(out, 1).movedim(1, -1).numpy(),
                               np.asarray(jax.nn.softmax(ref, -1)), rtol=0,
                               atol=1e-4)


def test_state_dict_keys_are_what_import_swinunet_reads(tiny_jax,
                                                        monkeypatch):
    """The port's state_dict keys, those of the JAX-to-port walk and those
    ``import_swinunet`` reads are one set, and the round trip JAX -> port
    -> ``import_swinunet`` gives the same params back."""
    _, params, _, _ = tiny_jax
    sd = swinunet_state_dict_from_jax(params)
    model_keys = get_model(config_from_dict(TINY),
                           device="cpu").state_dict().keys()
    read = set()

    class Recording(dict):
        def __contains__(self, key):
            read.add(key)
            return super().__contains__(key)

    to_np = torch_import._to_np
    monkeypatch.setattr(torch_import, "_to_np",
                        lambda state: Recording(to_np(state)))
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    back = torch_import.import_swinunet(sd, zeros)
    assert set(sd) == set(model_keys) == read
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(back_flat) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _swinunet_trajectory():
    jm = _jax_model()
    params0 = jax_params(jm, (1, SIZE, SIZE, 1), seed=9, train=False)
    with fast_xla_compile():
        return jax_trajectory(jm, TINY, SIZE, params0, nd=2)


def test_swinunet_three_step_trajectory_matches_make_train_step(
        monkeypatch):
    """fp32, AdamW + EMA, drop_path_rate 0, weights carried by
    ``swinunet_state_dict_from_jax``: the step-0 gradients, the losses and
    the params after three steps; no step reaches the kernel's wrapper."""
    def refuse(*args, **kw):
        raise AssertionError("the window-attention kernel in a train step")

    monkeypatch.setattr(swin_layers, "window_attention", refuse)
    model = get_model(config_from_dict(TINY), device="cpu", train=True)
    check_trajectory(model, swinunet_state_dict_from_jax, TINY,
                     _swinunet_trajectory())


def test_drop_path_rates_and_the_train_state_generator():
    """The rates are a linspace up to drop_path_rate over the encoder's 12
    blocks, each decoder stage reusing its encoder stage's; the train
    state seeds one generator for them, so a seeded training forward is
    repeatable, and differs from the same weights without DropPath."""
    cfg = config_from_dict(dict(TINY, drop_path_rate=0.1))
    model = get_model(cfg, device="cpu", train=True,
                      generator=torch.Generator().manual_seed(0))
    rates = {n: m.p for n, m in model.named_modules()
             if isinstance(m, swin_layers.DropPath)}
    want = np.linspace(0, 0.1, 12)
    enc = [rates[f"swin_unet.layers.{i}.blocks.{b}.drop_path"]
           for i, d in enumerate(swin_unet.DEPTHS) for b in range(d)]
    np.testing.assert_allclose(enc, want, rtol=0, atol=1e-7)
    # layers_up.1 decodes stage 2 (blocks 4..9 of the encoder's 12)
    assert rates["swin_unet.layers_up.1.blocks.5.drop_path"] == \
        pytest.approx(want[9])
    x = torch.from_numpy(_x((2, 1, SIZE, SIZE), 10))
    outs = []
    for _ in range(2):
        create_train_state(model, cfg, seed=3)
        with torch.no_grad():
            outs.append(model(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with torch.no_grad():
        plain = model.eval()(x)
    assert not torch.allclose(outs[0], plain)


def test_served_request_matches_the_jax_cli(tmp_path, monkeypatch):
    """One cine-MR-like request (6 slices, resampled in-plane) served by the
    port's prediction CLI and by the JAX package's (``prediction.py``, on
    the same reference-layout ``.pth``, the tiny model in place of the
    factory's full width): the label maps are equal."""
    import yaml
    import prediction as jax_prediction
    import cbim_tpu.models
    import cbim_tpu.utils

    cfg = config_from_dict(TINY)
    weights = tmp_path / "w.pth"
    torch.save(get_model(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
               .state_dict(), weights)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    img = _x((6, 50, 46), 11)
    write_nifti(str(in_dir / "case.nii.gz"), img, spacing=(10.0, 1.25, 1.25))
    args = ["--dataset", "synthetic", "--model", "swinunet", "--dimension",
            "2d", "--load", str(weights), "--img_path", str(in_dir),
            "--target_spacing", "1.5,1.5"]
    prediction.main(args + ["--save_path", str(tmp_path / "port"),
                            "--device", "cpu"], cfg=cfg)

    conf = tmp_path / "configs" / "synthetic"
    conf.mkdir(parents=True)
    (conf / "swinunet_2d.yaml").write_text(yaml.safe_dump(dict(
        {k: v for k, v in TINY.items()
         if k not in ("dataset", "model", "dimension")}, classes=4)))
    monkeypatch.setattr(cbim_tpu.models, "get_model",
                        lambda c: _jax_model())
    monkeypatch.setattr(cbim_tpu.utils, "enable_compile_cache",
                        lambda: None)
    monkeypatch.setattr(sys, "argv", ["prediction.py", *args, "--save_path",
                                      str(tmp_path / "jax"), "--config_root",
                                      str(tmp_path / "configs")])
    with fast_xla_compile():
        jax_prediction.main()
    port = read_nifti(str(tmp_path / "port" / "case.nii.gz")).data
    ref = read_nifti(str(tmp_path / "jax" / "case.nii.gz")).data
    assert port.shape == img.shape and port.dtype == np.uint8
    assert len(np.unique(ref)) > 1
    np.testing.assert_array_equal(port, ref)


def test_acdc_config_loads_and_matches_the_chip_smoke_recipe():
    """``configs/acdc/swinunet_2d.yaml`` loads through ``load_config`` into
    the full-width model (embedding 96, depths (2, 2, 6, 2), 4 classes,
    windows of 7, drop-path rate 0.1, 224^2), served without a sliding
    window in validation, and ``chip_smoke.py``'s ACDC_SU dict carries its
    model and inference keys."""
    pytest.importorskip("yaml")
    from cbim_tpu_torch.config import load_config
    import runpy
    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    cfg = load_config("acdc", "swinunet", "2d")
    for key, value in smoke["ACDC_SU"].items():
        assert cfg.get(key) == value, key
    assert cfg.sliding_window is False
    model = get_model(cfg, device="cpu")
    sw = model.swin_unet
    assert model.img_size == 224
    assert sw.patch_embed.proj.in_channels == 3
    assert sw.patch_embed.proj.out_channels == 96
    assert sw.output.out_channels == 4
    assert [len(layer.blocks) for layer in sw.layers] == [2, 2, 6, 2]
    assert [len(sw.layers_up[i].blocks) for i in (1, 2, 3)] == [6, 2, 2]
    assert sw.concat_back_dim[1].bias is not None
    assert sw.layers[3].blocks[1].drop_path.p == pytest.approx(0.1)


def test_train_cli_runs_swinunet_on_the_cpu(tmp_path):
    """``train.main --model swinunet --dimension 2d`` with no new flag: an
    epoch of slice-batch steps with stochastic depth, then the EMA model's
    whole-image evaluation (the kernel's route) of the test volumes
    centre-cropped to the training size."""
    import json
    from cbim_tpu_torch import train as train_cli
    cfg = config_from_dict(dict(
        TINY, drop_path_rate=0.1, epochs=1, print_freq=1, val_freq=1,
        affine_pad_size=[8, 8], scale=0.3, rotate=180, translate=0,
        gaussian_noise_std=0.02, synthetic_cases=3, k_fold=3,
        sliding_window=False, device_cache=False))
    train_cli.main(["--dataset", "synthetic", "--model", "swinunet",
                    "--dimension", "2d", "--batch_size", "4", "--cp_path",
                    str(tmp_path / "exp"), "--log_path", str(tmp_path / "log"),
                    "--unique_name", "su", "--folds", "1", "--device", "cpu"],
                   cfg=cfg)
    run = tmp_path / "exp" / "synthetic" / "su"
    assert (run / "fold_0_best.ckpt").exists()
    rows = [json.loads(ln) for ln in
            (tmp_path / "log" / "synthetic" / "su" / "fold_0" /
             "scalars.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in rows if r["tag"] == "Train/StepLoss"]
    assert len(losses) == 12 // 4 and np.isfinite(losses).all()
    assert any(r["tag"].startswith("Dice/") for r in rows)
