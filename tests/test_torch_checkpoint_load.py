"""One weights loader for the prediction CLI and the trainer
(``training.checkpoint.load_weights``), on the CPU.

It reads the port trainer's ``.ckpt`` (EMA weights with ``prefer_ema``),
the reference trainer's {model_state_dict, ema_model_state_dict} wrapper
(EMA first, as ``cbim_tpu.utils.torch_import.load_torch_state_dict``) and
bare ``.pth`` state_dicts; it drops a reference Swin checkpoint's
``relative_position_index`` (and SwinUnet's ``attn_mask``) buffers and
nothing else, and maps the JAX package's Flax msgpack ``.ckpt`` only with
the model's config (``tests/test_torch_flax_ckpt.py`` loads them).
Every comparison is exact: loading copies tensors.
"""

import numpy as np
import pytest
import torch
from flax import serialization

from cbim_tpu.utils.torch_import import load_torch_state_dict
from cbim_tpu_torch import prediction
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.nifti import write_nifti
from cbim_tpu_torch.inference import engines
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.training.checkpoint import (load_weights,
                                                read_state_dict,
                                                save_checkpoint)
from cbim_tpu_torch.training.train_state import create_train_state
from cbim_tpu_torch.training.trainer import load_pretrained
from test_torch_medformer2d import TINY2D
from test_torch_threads import few_torch_threads  # noqa: F401

#: the narrow MedFormer-2D (BatchNorm: running statistics ride along) with
#: an EMA, at 32^2
CFG2D = dict(TINY2D, training_size=[32, 32], window_size=[32, 32],
             sliding_window=True, ema=True, ema_alpha=0.99,
             optimizer="adamw", base_lr=5e-4)
#: a narrow SwinUNETR (relative_position_index buffers at every block)
SWIN = dict(dataset="synthetic", model="swin_unetr", dimension="3d",
            classes=3, in_chan=1, base_chan=12, training_size=[32, 32, 32])


def _seeded(cfg, seed, stats=False):
    """A CPU model with seeded weights; with ``stats``, its BatchNorm
    running statistics drawn from the seed too."""
    gen = torch.Generator().manual_seed(seed)
    model = get_model(config_from_dict(cfg), device="cpu", generator=gen)
    if stats:
        with torch.no_grad():
            for name, buf in model.named_buffers():
                if name.endswith("running_mean"):
                    buf.normal_(generator=gen)
                elif name.endswith("running_var"):
                    buf.uniform_(0.5, 2.0, generator=gen)
    return model


def _assert_same(model, sd):
    got = model.state_dict()
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def _trainer_ckpt(path):
    """A port trainer's .ckpt whose model and EMA differ in every
    parameter and BatchNorm statistic; returns (model sd, ema sd)."""
    cfg = config_from_dict(CFG2D)
    state = create_train_state(_seeded(CFG2D, 0, stats=True), cfg)
    state.ema.load_state_dict(_seeded(CFG2D, 1, stats=True).state_dict())
    save_checkpoint(str(path), state, epoch=2)
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema.state_dict().items()})


@pytest.mark.parametrize("prefer_ema", [True, False])
def test_load_weights_reads_the_trainers_ckpt(tmp_path, prefer_ema):
    """``ema`` with ``prefer_ema`` (its BatchNorm running statistics
    included: the EMA copies buffers), else ``model``."""
    model_sd, ema_sd = _trainer_ckpt(tmp_path / "fold_0_latest.ckpt")
    fresh = _seeded(CFG2D, 5)
    load_weights(str(tmp_path / "fold_0_latest.ckpt"), fresh, prefer_ema)
    _assert_same(fresh, ema_sd if prefer_ema else model_sd)


@pytest.mark.parametrize("ema", [True, False])
def test_prediction_cli_serves_the_trainers_ckpt(tmp_path, monkeypatch, ema):
    """train -> serve closes: ``--load`` takes the trainer's .ckpt, its EMA
    weights when the config sets ``ema`` (as the JAX CLI's
    ``load_params_for_eval(prefer_ema=cfg.ema)``), else its ``model``."""
    ckpt = tmp_path / "fold_0_latest.ckpt"
    model_sd, ema_sd = _trainer_ckpt(ckpt)
    served = []
    make_engine = engines.make_engine

    def recording(model, cfg, **kw):
        served.append(model)
        return make_engine(model, cfg, **kw)

    monkeypatch.setattr(engines, "make_engine", recording)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    write_nifti(str(in_dir / "a.nii.gz"), np.random.default_rng(0).normal(
        size=(3, 30, 26)).astype(np.float32), spacing=(5.0, 1.0, 1.0))
    seconds = prediction.main(
        ["--dataset", "synthetic", "--model", "medformer", "--dimension",
         "2d", "--load", str(ckpt), "--img_path", str(in_dir),
         "--save_path", str(tmp_path / "out"), "--target_spacing",
         "1.0,1.0", "--device", "cpu"],
        cfg=config_from_dict(dict(CFG2D, ema=ema)))
    assert list(seconds) == ["a.nii.gz"] and len(served) == 1
    _assert_same(served[0], ema_sd if ema else model_sd)


@pytest.mark.parametrize("with_ema", [True, False])
def test_reference_wrapper_loads_its_ema_weights_first(tmp_path, with_ema):
    """{model_state_dict, ema_model_state_dict, epoch, ...}: the EMA weights
    when present, whatever ``prefer_ema`` says, else the model's: the same
    state_dict ``cbim_tpu``'s ``load_torch_state_dict`` reads."""
    model_sd = _seeded(CFG2D, 0, stats=True).state_dict()
    ema_sd = _seeded(CFG2D, 1, stats=True).state_dict()
    path = tmp_path / "best.pth"
    torch.save({"epoch": 7, "model_state_dict": model_sd,
                "ema_model_state_dict": ema_sd if with_ema else None}, path)
    want = ema_sd if with_ema else model_sd
    fresh = _seeded(CFG2D, 5)
    load_weights(str(path), fresh, prefer_ema=False)
    _assert_same(fresh, want)
    ref = load_torch_state_dict(str(path))
    assert ref.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(ref[k], v.numpy(), err_msg=k)


def test_bare_pth_state_dict_loads_as_it_is(tmp_path):
    sd = _seeded(CFG2D, 2, stats=True).state_dict()
    torch.save(sd, tmp_path / "w.pth")
    fresh = _seeded(CFG2D, 5)
    load_weights(str(tmp_path / "w.pth"), fresh, prefer_ema=True)
    _assert_same(fresh, sd)


def test_swin_unetr_pth_with_relative_position_index_keys_loads(tmp_path):
    """A reference SwinUNETR state_dict carries every block's
    ``relative_position_index``; the port keeps it as a non-persistent
    buffer (ROADMAP C8), so those keys, and only those, are dropped."""
    model = _seeded(SWIN, 0)
    sd = dict(model.state_dict())
    index = {k: b for k, b in model.named_buffers()
             if k.endswith(".relative_position_index")}
    assert index and not index.keys() & sd.keys()
    torch.save({**sd, **index}, tmp_path / "swin.pth")
    fresh = _seeded(SWIN, 5)
    load_weights(str(tmp_path / "swin.pth"), fresh)
    _assert_same(fresh, sd)


def test_prediction_cli_serves_a_reference_swin_unetr_pth(tmp_path):
    """The same Swin checkpoint through ``prediction.main`` end to end."""
    model = _seeded(SWIN, 0)
    index = {k: b for k, b in model.named_buffers()
             if k.endswith(".relative_position_index")}
    torch.save({"model_state_dict": {**model.state_dict(), **index},
                "ema_model_state_dict": None}, tmp_path / "swin.pth")
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    write_nifti(str(in_dir / "a.nii.gz"), np.random.default_rng(1).normal(
        size=(20, 24, 28)).astype(np.float32), spacing=(1.5, 1.5, 1.5))
    seconds = prediction.main(
        ["--dataset", "synthetic", "--model", "swin_unetr", "--load",
         str(tmp_path / "swin.pth"), "--img_path", str(in_dir),
         "--save_path", str(tmp_path / "out"), "--target_spacing",
         "1.5,1.5,1.5", "--device", "cpu"], cfg=config_from_dict(SWIN))
    assert list(seconds) == ["a.nii.gz"]


@pytest.mark.parametrize("fault", ["stray", "missing"])
def test_any_other_unknown_or_missing_key_still_raises(tmp_path, fault):
    sd = dict(_seeded(CFG2D, 2).state_dict())
    if fault == "stray":
        sd["inc.conv1.relative_position_bias"] = torch.zeros(3)
    else:
        del sd["outc.weight"]
    torch.save(sd, tmp_path / "w.pth")
    with pytest.raises(RuntimeError, match="outc.weight|relative_position_b"):
        load_weights(str(tmp_path / "w.pth"), _seeded(CFG2D, 5))


def test_flax_msgpack_ckpt_raises_the_a5_error(tmp_path):
    """The JAX package writes its .ckpt as Flax msgpack (not a zip archive,
    which is what ``torch.save`` writes): told apart by content and read
    (ROADMAP A5), but mapped onto a model only through its config, and a
    Flax tree whose params fit no part of the config's model raises the
    dispatcher's error."""
    path = tmp_path / "fold_0_best.ckpt"
    path.write_bytes(serialization.to_bytes(
        {"epoch": 1, "step": 2, "params": {"w": np.ones((2, 2), np.float32)}}))
    for load in (lambda: read_state_dict(str(path)),
                 lambda: load_weights(str(path), _seeded(CFG2D, 5))):
        with pytest.raises(ValueError, match="config"):
            load()
    with pytest.raises(ValueError, match="do not fit .*medformer"):
        load_weights(str(path), _seeded(CFG2D, 5),
                     cfg=config_from_dict(CFG2D))


def test_unported_weight_formats_raise(tmp_path):
    """A .npz is TransUNet's --pretrain backbone, not a weights file of
    the loader; other suffixes raise too."""
    with pytest.raises(NotImplementedError, match="TransUNet"):
        read_state_dict(str(tmp_path / "backbone.npz"))
    with pytest.raises(NotImplementedError, match="loads .pth"):
        read_state_dict(str(tmp_path / "model.safetensors"))


@pytest.mark.parametrize("kind", ["ckpt", "wrapper"])
def test_trainer_init_model_takes_the_same_loader(tmp_path, kind):
    """``init_model`` goes through ``load_weights`` too: the model and its
    EMA copy both start from the checkpoint's EMA weights."""
    if kind == "ckpt":
        path = tmp_path / "fold_0_latest.ckpt"
        _, want = _trainer_ckpt(path)
    else:
        path = tmp_path / "best.pth"
        want = _seeded(CFG2D, 1, stats=True).state_dict()
        torch.save({"model_state_dict": _seeded(CFG2D, 0).state_dict(),
                    "ema_model_state_dict": want}, path)
    cfg = config_from_dict(dict(CFG2D, init_model=str(path)))
    state = create_train_state(get_model(cfg, device="cpu", train=True), cfg)
    load_pretrained(cfg, state)
    _assert_same(state.model, want)
    _assert_same(state.ema, want)
