"""nnFormer in the PyTorch port vs ``cbim_tpu``'s, on the CPU.

Flax parameters are drawn with numpy from a seed on the tree's shapes, go
through ``nnformer_state_dict_from_jax`` (or the walker's per-block step)
into the port, and both run on the same numpy input: the relative index,
the window rule, the self and kv blocks, the tiny model's eval forward,
the key round trip through ``import_nnformer3d``, a 3-step trajectory
against ``make_train_step`` with ``drop_path_rate`` 0, DropPath's rates,
the prediction CLI, and the BCV recipe.  On the CPU the port's eval-mode
window attentions run the kernel's plain version (the launches are counted
where the wrapper is called), its training-mode ones the autograd route.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models import nnformer as jax_nf
from cbim_tpu.utils import torch_import
from cbim_tpu_torch import prediction
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.nifti import read_nifti, write_nifti
from cbim_tpu_torch.models import get_model, nnformer, swin_layers
from cbim_tpu_torch.ops.kernels import window_attention as wa
from cbim_tpu_torch.training.train_state import create_train_state
from cbim_tpu_torch.utils.jax_import import (_Walk,
                                             nnformer_state_dict_from_jax)
from test_torch_swin_train import (TRAJ_SIZE, check_trajectory,
                                   fast_xla_compile, jax_trajectory)
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: an nnFormer at an eighth of the width (embedding 24: head dim 8), the
#: reference's depths, heads, patch and windows, on 32^3 crops (a 16 x 8 x 8
#: token grid: shifted windows of 4 at stage 0, windows shrunk to 4, 2 and
#: 1 with no shift below), deep supervision with the BCV recipe's weights
#: and training keys, no stochastic depth
TINY = dict(
    dataset="synthetic", model="nnformer", dimension="3d", classes=3,
    in_chan=1, embedding_dim=24, drop_path_rate=0.0,
    training_size=[32, 32, 32], window_size=[32, 32, 32], aux_loss=True,
    aux_weight=[0.2, 0.3, 0.5], weight=[0.5, 1.0, 1.0], rlt=1,
    optimizer="adamw", base_lr=6e-4, betas=[0.9, 0.999], weight_decay=0.05,
    ema=True, ema_alpha=0.99, split_seed=0)
#: window-attention calls of a forward: 8 encoder blocks, 6 decoder blocks
ATTENTIONS = 14
FC = ("fc1", "fc2")


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_model(drop_path_rate=0.0):
    return jax_nf.NNFormer(num_classes=3, crop_size=(32, 32, 32),
                           embedding_dim=24, drop_path_rate=drop_path_rate)


def _ndhwc_to_port(x):
    return torch.from_numpy(x).movedim(-1, 1).contiguous(
        memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("window", [(4, 4, 4), (8, 8, 8), (2, 2, 2),
                                    (3, 4, 5), (1, 1, 1)])
def test_relative_index_matches_jax(window):
    """nnFormer's colliding multipliers, exactly."""
    got = nnformer.nnformer_rel_index(window)
    np.testing.assert_array_equal(got, jax_nf._nnformer_rel_index(window))
    n = int(np.prod(window))
    assert got.shape == (n, n)
    if window == (4, 4, 4):
        # the quirk: fewer distinct entries than offsets
        assert len(np.unique(got)) < len(np.unique(
            swin_layers.relative_position_index(window)))


@pytest.mark.parametrize("window,shift,spatial", [
    (4, 2, (3, 8, 8)), (4, 2, (16, 8, 8)), (8, 0, (16, 8, 8)),
    (4, 2, (8, 4, 4)), (4, 2, (5, 6, 7)), (7, 3, (7, 20, 20))])
def test_effective_window_matches_jax(window, shift, spatial):
    """Shrunk to the smallest extent on every axis, shift dropped, where
    the Swin rule would work per axis."""
    assert nnformer.effective_window(window, shift, spatial) == \
        jax_nf._effective(window, shift, spatial)


def _block_state_dict(params, kv):
    walk = _Walk(params)
    walk.swin_block((), "blk", "_WindowAttentionNF_0",
                    qkv="kv" if kv else "qkv", mlp=FC)
    return {k[4:]: v for k, v in walk.state_dict().items()}


@pytest.mark.parametrize("spatial,window,shift", [
    ((8, 8, 8), 4, 2), ((8, 8, 8), 4, 0), ((3, 8, 8), 4, 2)])
def test_self_block_matches_jax(spatial, window, shift):
    """A self-attention block against ``_NFBlock``, eval mode, batch 2 (the
    shifted block's region ids wrap at b % nW); (3, 8, 8) at window 4
    shrinks the window to 3, drops the shift and pads to (3, 9, 9)."""
    C, heads = 16, 2
    x = _x((2, *spatial, C), 1)
    jm = jax_nf._NFBlock(heads, window, shift)
    params = jax_params(jm, x.shape, seed=2)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    block = nnformer.NFBlock(C, heads, window, shift, spatial).eval()
    block.load_state_dict(_block_state_dict(params, kv=False))
    with torch.inference_mode():
        out = block(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("spatial", [(8, 8, 8), (4, 8, 8)])
def test_kv_block_matches_jax(spatial):
    """The decoder's first block: q the normed upsampled path (no
    projection), k and v projected from the normed skip, the residual on
    their sum; eval mode (the kernel's route, one packed q, k, v) and
    training mode (the autograd route) against ``_NFBlock(kv_mode=True)``."""
    C, heads = 16, 2
    x_up, skip = _x((2, *spatial, C), 3), _x((2, *spatial, C), 4)
    summed = x_up + skip
    jm = jax_nf._NFBlock(heads, 4, 0, kv_mode=True)
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(
            lambda k: jm.init({"params": k}, jnp.asarray(summed),
                              skip=jnp.asarray(skip), x_up=jnp.asarray(x_up)),
            jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.normal(0, 0.02 if path[-1].key ==
                                    "relative_position_bias_table" else 0.2,
                                    s.shape)
                         + (1.0 if path[-1].key == "scale" else 0.0)
                         ).astype(np.float32), shapes["params"])
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(summed),
                              skip=jnp.asarray(skip), x_up=jnp.asarray(x_up)))
    block = nnformer.NFBlock(C, heads, 4, 0, spatial, kv_mode=True)
    block.load_state_dict(_block_state_dict(params, kv=True))
    assert "attn.kv.weight" in block.state_dict()
    args = [torch.from_numpy(t) for t in (summed, skip, x_up)]
    with torch.inference_mode():
        out = block.eval()(args[0], skip=args[1], x_up=args[2])
    train_out = block.train()(args[0], skip=args[1], x_up=args[2])
    for got in (out, train_out.detach()):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_block_refuses_a_grid_its_table_does_not_fit():
    """The bias table is sized by the crop's window: a grid whose window
    differs raises instead of indexing past the table."""
    block = nnformer.NFBlock(16, 2, 4, 2, (8, 8, 8)).eval()
    with pytest.raises(ValueError, match="bias table"):
        block(torch.zeros(1, 3, 8, 8, 16))


@pytest.fixture(scope="module")
def tiny_jax():
    """The JAX nnFormer at TINY's size: its drawn params, an input and the
    three heads' eval logits (jitted with XLA's optimisations off)."""
    jm = _jax_model()
    shape = (1, TRAJ_SIZE, TRAJ_SIZE, TRAJ_SIZE, 1)
    params = jax_params(jm, shape, seed=7, train=False)
    x = _x(shape, 8)
    with fast_xla_compile():
        heads = jax.jit(lambda p, t: jm.apply({"params": p}, t,
                                              train=False))(params, x)
    return jm, params, x, [np.asarray(h) for h in heads]


def test_tiny_nnformer_matches_jax(tiny_jax, monkeypatch):
    """The eval forward through the kernel's wrapper, 14 calls, each with
    q, k, v the kernel can stage (the kv blocks pack their q with the
    projected k and v), against the JAX model: every head's softmax within
    1e-4, finest first."""
    _, params, x, ref = tiny_jax
    calls = []

    def recorded(q, k, v, rel_bias, region=None):
        wa._check_kernel_view(q, k, v)
        calls.append(q.shape)
        return wa.window_attention(q, k, v, rel_bias, region)

    monkeypatch.setattr(swin_layers, "window_attention", recorded)
    model = get_model(config_from_dict(TINY), device="cpu")
    model.load_state_dict(nnformer_state_dict_from_jax(params))
    with torch.inference_mode():
        out = model(_ndhwc_to_port(x))
    assert len(calls) == ATTENTIONS
    assert {c[2] for c in calls} == {64, 8, 1}
    assert isinstance(out, list) and len(out) == 3
    for got, want in zip(out, ref):
        assert got.dtype == torch.float32 and got.shape == (1, 3, 32, 32, 32)
        np.testing.assert_allclose(
            torch.softmax(got, 1).movedim(1, -1).numpy(),
            np.asarray(jax.nn.softmax(want, -1)), rtol=0, atol=1e-4)


def test_state_dict_keys_are_what_import_nnformer3d_reads(tiny_jax,
                                                          monkeypatch):
    """The port's state_dict keys, those of the JAX-to-port walk and those
    ``import_nnformer3d`` reads are one set, and the round trip JAX ->
    port -> ``import_nnformer3d`` gives the same params back."""
    _, params, _, _ = tiny_jax
    sd = nnformer_state_dict_from_jax(params)
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
    back = torch_import.import_nnformer3d(sd, zeros)
    assert set(sd) == set(model_keys) == read
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(back_flat) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _nnformer_trajectory():
    jm = _jax_model()
    params0 = jax_params(jm, (1, TRAJ_SIZE, TRAJ_SIZE, TRAJ_SIZE, 1), seed=9,
                         train=False)
    with fast_xla_compile():
        return jax_trajectory(jm, TINY, TRAJ_SIZE, params0)


def test_nnformer_three_step_trajectory_matches_make_train_step(monkeypatch):
    """fp32, AdamW + EMA, deep supervision (0.2, 0.3, 0.5), drop_path_rate
    0, weights carried by ``nnformer_state_dict_from_jax``: the step-0
    gradients, the losses and the params after three steps; no step
    reaches the kernel's wrapper."""
    def refuse(*args, **kw):
        raise AssertionError("the window-attention kernel in a train step")

    monkeypatch.setattr(swin_layers, "window_attention", refuse)
    model = get_model(config_from_dict(TINY), device="cpu", train=True)
    check_trajectory(model, nnformer_state_dict_from_jax, TINY,
                     _nnformer_trajectory())


def test_drop_path_rates_and_the_train_state_generator():
    """The rates are a linspace up to drop_path_rate over the encoder's 8
    blocks and, separately, over the decoder's 6; the train state seeds one
    generator for them, so a seeded training forward is repeatable, and
    differs from the same weights without DropPath."""
    cfg = config_from_dict(dict(TINY, drop_path_rate=0.2))
    model = get_model(cfg, device="cpu", train=True,
                      generator=torch.Generator().manual_seed(0))
    rates = {n: m.p for n, m in model.named_modules()
             if isinstance(m, swin_layers.DropPath)}
    enc = [rates[f"model_down.layers.{i}.blocks.{b}.drop_path"]
           for i in range(4) for b in range(2)]
    np.testing.assert_allclose(enc, np.linspace(0, 0.2, 8), rtol=0,
                               atol=1e-7)
    # decoder stage j = 0 (the coarsest) is decoder.layers.2
    dec = [rates[f"decoder.layers.{k}.blocks.{b}.drop_path"]
           for k in (2, 1, 0) for b in range(2)]
    np.testing.assert_allclose(dec, np.linspace(0, 0.2, 6), rtol=0,
                               atol=1e-7)
    x = torch.from_numpy(_x((2, 1, 32, 32, 32), 10))
    outs = []
    for _ in range(2):
        create_train_state(model, cfg, seed=3)
        with torch.no_grad():
            outs.append(model(x)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with torch.no_grad():
        plain = model.eval()(x)[0]
    assert not torch.allclose(outs[0], plain)


def test_prediction_main_serves_nnformer_on_the_cpu(tmp_path):
    """The CLI serves head 0 of the deep-supervision list by a sliding
    window at the training size."""
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
        ["--dataset", "synthetic", "--model", "nnformer", "--dimension",
         "3d", "--load", str(weights), "--img_path", str(in_dir),
         "--save_path", str(out_dir), "--target_spacing", "1.5,1.5,1.5",
         "--device", "cpu"], cfg=cfg)
    assert list(seconds) == ["case.nii.gz"]
    pred = read_nifti(str(out_dir / "case.nii.gz"))
    assert pred.data.shape == img.shape and pred.data.dtype == np.uint8
    assert pred.data.max() < TINY["classes"]


def test_bcv_config_loads_and_matches_the_chip_smoke_recipe():
    """``configs/bcv/nnformer_3d.yaml`` loads through ``load_config`` into
    the full-width model (embedding 192, patch (2, 4, 4), 14 classes, three
    heads, drop-path rate 0.2), whose blocks take N = 64 at stages 0, 1 and
    3 and N = 512 at stage 2, D = 32 everywhere, and ``chip_smoke.py``'s
    BCV_NN dict carries its model and inference keys."""
    pytest.importorskip("yaml")
    from cbim_tpu_torch.config import load_config
    import runpy
    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    cfg = load_config("bcv", "nnformer", "3d")
    for key, value in smoke["BCV_NN"].items():
        assert cfg.get(key) == value, key
    model = get_model(cfg, device="cpu")
    md = model.model_down
    assert md.patch_embed.proj2.conv2.out_channels == 192
    assert len(model.final) == 3 and model.final[0].up.out_channels == 14
    assert tuple(model.final[0].up.kernel_size) == (2, 4, 4)
    windows = [(blk.window_size, blk.shift_size, blk.attn.num_heads)
               for layer in md.layers for blk in layer.blocks]
    assert windows == [((4,) * 3, (0,) * 3, 6), ((4,) * 3, (2,) * 3, 6),
                       ((4,) * 3, (0,) * 3, 12), ((4,) * 3, (2,) * 3, 12),
                       ((8,) * 3, (0,) * 3, 24), ((8,) * 3, (0,) * 3, 24),
                       ((4,) * 3, (0,) * 3, 48), ((4,) * 3, (0,) * 3, 48)]
    dims = {blk.norm1.normalized_shape[0] // blk.attn.num_heads
            for layer in list(md.layers) + list(model.decoder.layers)
            for blk in layer.blocks}
    assert dims == {32}
    assert md.layers[3].blocks[1].drop_path.p == pytest.approx(0.2)


def test_train_cli_runs_nnformer_on_the_cpu(tmp_path):
    """``train.main --model nnformer`` with no new flag: steps with deep
    supervision and stochastic depth, then the EMA model's sliding-window
    evaluation (head 0, the kernel's route)."""
    import json
    from cbim_tpu_torch import train as train_cli
    cfg = config_from_dict(dict(
        TINY, drop_path_rate=0.2, epochs=1, iter_per_epoch=2, print_freq=1,
        val_freq=1, affine_pad_size=[4, 4, 4], synthetic_cases=3, k_fold=3,
        sliding_window=True, device_cache=False))
    train_cli.main(["--dataset", "synthetic", "--model", "nnformer",
                    "--dimension", "3d", "--batch_size", "2", "--cp_path",
                    str(tmp_path / "exp"), "--log_path", str(tmp_path / "log"),
                    "--unique_name", "nf", "--folds", "1", "--device", "cpu"],
                   cfg=cfg)
    assert (tmp_path / "exp" / "synthetic" / "nf" /
            "fold_0_best.ckpt").exists()
    rows = [json.loads(ln) for ln in
            (tmp_path / "log" / "synthetic" / "nf" / "fold_0" /
             "scalars.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in rows if r["tag"] == "Train/StepLoss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any(r["tag"].startswith("Dice/") for r in rows)
