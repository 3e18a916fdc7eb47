"""The JAX package's Flax msgpack checkpoints in the PyTorch port, on the CPU.

Files are written by ``cbim_tpu.training.checkpoint.save_checkpoint``
(``async_write=False``) from JAX train states: the port's reader
(``utils.flax_msgpack``) equals ``flax.serialization.msgpack_restore`` leaf
for leaf (a bfloat16 leaf, a 0-d ``step``, an EMA-less run's empty
``ema_params``, a chunked leaf); a tiny MedFormer-3D's and ResUNet-3D's
checkpoints serve through the port's prediction CLI to the label maps of
the JAX prediction CLI on the same file; a MedFormer-2D's (BatchNorm)
loads with the file's EMA statistics (ROADMAP C10: the JAX CLI would serve
initial ones); the trainer's ``init_model`` takes the same loader; and a
truncated file, an Orbax directory and a Flax file without a config are
refused.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.training import checkpoint as jax_checkpoint
from cbim_tpu.training.optim import get_optimizer as jax_get_optimizer
from cbim_tpu.training.train_state import TrainState as JaxTrainState
from cbim_tpu.utils import torch_import
from cbim_tpu_torch import prediction
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.nifti import read_nifti, write_nifti
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.training.checkpoint import (load_weights, read_payload,
                                                read_state_dict)
from cbim_tpu_torch.training.train_state import create_train_state
from cbim_tpu_torch.training.trainer import load_pretrained
from cbim_tpu_torch.utils import flax_msgpack
from cbim_tpu_torch.utils.jax_import import (medformer2d_state_dict_from_jax,
                                             state_dict_from_jax)
from test_torch_medformer import TINY as MF3D
from test_torch_medformer import jax_medformer
from test_torch_medformer2d import TINY2D
from test_torch_swin_train import fast_xla_compile
from test_torch_swin_unetr import jax_params
from test_torch_unet3d import ZOO, port_params_in_jax
from test_torch_threads import few_torch_threads  # noqa: F401

#: the served recipes: 32^3 windows, EMA weights (the CLIs' prefer_ema)
SERVE = dict(training_size=[32, 32, 32], ema=True, optimizer="adamw",
             base_lr=1e-3, betas=[0.9, 0.999], weight_decay=0.05)
RESUNET = dict(ZOO, model="resunet", **SERVE)
MEDFORMER = dict(MF3D, **SERVE)


def _perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + scale * rng.normal(
        size=np.shape(a))).astype(np.float32), tree)


def write_jax_checkpoint(path, d, params, batch_stats=None, ema=True,
                         ema_batch_stats=None, step=7):
    """A JAX trainer's checkpoint of ``params`` through its
    ``save_checkpoint``: AdamW state of the config, EMA params 5e-2 off
    the params (or none: ``{}``)."""
    tx = jax_get_optimizer(config_from_dict(d))
    state = JaxTrainState(
        step=jnp.asarray(step, jnp.int32), params=params,
        opt_state=tx.init(params), batch_stats=batch_stats or {},
        ema_params=_perturbed(params, 1) if ema else None,
        ema_batch_stats=ema_batch_stats)
    jax_checkpoint.save_checkpoint(str(path), state, 3, async_write=False)
    return state


def bn_variables(jm, shape, seed):
    """Flax variables of a BatchNorm model drawn with numpy: the params as
    ``jax_params`` draws them, every running mean N(0, 0.3^2) and variance
    U(0.5, 2) (not the initial 0 and 1)."""
    shapes = jax.eval_shape(
        lambda x: jm.init({"params": jax.random.PRNGKey(0)}, x, train=False),
        jax.ShapeDtypeStruct(shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key == "mean":
            return (0.3 * rng.normal(size=s.shape)).astype(np.float32)
        return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)

    return {"params": jax_params(jm, shape, seed),
            "batch_stats": jax.tree_util.tree_map_with_path(
                draw, shapes["batch_stats"])}


def _same_leaves(got, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys(), path
        for k in ref:
            _same_leaves(got[k], ref[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(), np.asarray(ref).view(np.int16),
            err_msg=path)
    else:
        assert type(got) is type(ref), (path, type(got), type(ref))
        if isinstance(ref, np.ndarray):
            assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=path)


@pytest.mark.parametrize("chunked", [False, True])
def test_reader_equals_msgpack_restore(tmp_path, monkeypatch, chunked):
    """A JAX checkpoint with a bfloat16 leaf and int and float leaves of
    every rank, an EMA-less run's ``{}``, AdamW's state (its count a 0-d
    int32, its tuples dicts of "0", "1", ...): leaf for leaf what flax reads;
    with a low ``MAX_CHUNK_SIZE`` the large leaves are chunked, and
    rebuilt."""
    params = {"conv": {"kernel": np.random.default_rng(0).normal(
                  size=(3, 3, 3, 2, 4)).astype(np.float32),
                       "bias": np.zeros(4, np.float32)},
              "half": jnp.arange(40, dtype=jnp.bfloat16).reshape(5, 8) / 3,
              "count": np.arange(6, dtype=np.int64).reshape(2, 3)}
    if chunked:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    path = tmp_path / "fold_0_latest.ckpt"
    write_jax_checkpoint(path, RESUNET, params, ema=False)
    data = path.read_bytes()
    assert (b"__msgpack_chunked_array__" in data) == chunked
    ref = serialization.msgpack_restore(data)
    got = flax_msgpack.read_flax_msgpack(str(path))
    _same_leaves(got, ref)
    assert got["ema_params"] == {} and got["epoch"] == 3
    assert isinstance(got["step"], np.ndarray) and got["step"].shape == ()
    assert got["params"]["half"].dtype == torch.bfloat16


def _serve_both(tmp_path, monkeypatch, d, name, jm, params):
    """One request served from ``fold_0_best.ckpt`` of ``params`` by the
    port's CLI and by the JAX package's (``prediction.py``, the tiny model
    in place of the factory's): both label maps."""
    import yaml
    import prediction as jax_prediction
    import cbim_tpu.models
    import cbim_tpu.utils

    ckpt = tmp_path / "fold_0_best.ckpt"
    write_jax_checkpoint(ckpt, d, params)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    img = np.random.default_rng(3).normal(size=(30, 34, 28)).astype(
        np.float32)
    write_nifti(str(in_dir / "case.nii.gz"), img, spacing=(1.6, 1.4, 1.5))
    args = ["--dataset", "synthetic", "--model", name, "--dimension", "3d",
            "--load", str(ckpt), "--img_path", str(in_dir),
            "--target_spacing", "1.5,1.5,1.5"]
    prediction.main(args + ["--save_path", str(tmp_path / "port"),
                            "--device", "cpu"], cfg=config_from_dict(d))

    conf = tmp_path / "configs" / "synthetic"
    conf.mkdir(parents=True)
    (conf / f"{name}_3d.yaml").write_text(yaml.safe_dump(
        {k: v for k, v in d.items()
         if k not in ("dataset", "model", "dimension")}))
    monkeypatch.setattr(cbim_tpu.models, "get_model", lambda c: jm)
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
    return port, ref


@pytest.mark.parametrize("name", ["resunet", "medformer"])
def test_jax_checkpoint_serves_as_the_jax_cli_does(tmp_path, monkeypatch,
                                                   name):
    """The same Flax ``.ckpt`` (its EMA params, the config's ``ema``)
    served by both CLIs: equal label maps."""
    if name == "resunet":
        d = RESUNET
        jm = jax_get_model(config_from_dict(d))
        to_jax = functools.partial(torch_import.import_unet,
                                   block="BasicBlock")
        # the trained weights: the default init (torch's, which the JAX
        # package's initializers copy), drawn by the port
        params = port_params_in_jax(d, jm, to_jax, 6, (1, 32, 32, 32))
    else:
        # (import_medformer3d cannot carry this config's up2, ROADMAP C6)
        d, jm = MEDFORMER, jax_medformer(MEDFORMER)
        params = jax_params(jm, (1, 32, 32, 32, 1), seed=6)
    port, ref = _serve_both(tmp_path, monkeypatch, d, name, jm, params)
    assert len(np.unique(ref)) > 1
    np.testing.assert_array_equal(port, ref)


def test_medformer2d_loads_the_files_batch_statistics(tmp_path):
    """A MedFormer-2D checkpoint with trained (non-initial) BatchNorm
    statistics: with prefer_ema the port's softmax is within 1e-4 of the
    JAX model applied with the file's EMA params and ``ema_batch_stats``,
    its running buffers those statistics; without, the params and
    ``batch_stats`` exactly."""
    jm = jax_get_model(config_from_dict(TINY2D))
    v = bn_variables(jm, (1, 32, 32, 1), seed=2)
    ema_stats = _perturbed(v["batch_stats"], 2, scale=0.02)
    ema_stats = jax.tree.map(np.abs, ema_stats)     # variances stay > 0
    path = tmp_path / "fold_0_best.ckpt"
    state = write_jax_checkpoint(path, dict(TINY2D, **SERVE), v["params"],
                                 batch_stats=v["batch_stats"],
                                 ema_batch_stats=ema_stats)
    cfg = config_from_dict(TINY2D)
    model = get_model(cfg, device="cpu")
    load_weights(str(path), model, prefer_ema=True, cfg=cfg)
    x = np.random.default_rng(4).normal(size=(3, 32, 32, 1)).astype(
        np.float32)
    ref = jax.jit(jm.apply)({"params": state.ema_params,
                             "batch_stats": ema_stats}, jnp.asarray(x))[0]
    with torch.inference_mode():
        out = model(torch.from_numpy(x).movedim(-1, 1))[0]
    np.testing.assert_allclose(
        torch.softmax(out, 1).movedim(1, -1).numpy(),
        np.asarray(jax.nn.softmax(ref, -1)), rtol=0, atol=1e-4)
    mean = model.state_dict()["up1.norm.running_mean"]
    np.testing.assert_array_equal(
        mean.numpy(), ema_stats["UpBlockMF2D_0"]["Norm_0"]["BatchNorm_0"]
        ["mean"])
    assert float(mean.abs().max()) > 0       # not the initial zeros
    plain = read_state_dict(str(path), prefer_ema=False, cfg=cfg)
    want = medformer2d_state_dict_from_jax(v, cfg)
    for k, t in want.items():
        torch.testing.assert_close(plain[k], t, rtol=0, atol=0, msg=k)


def test_ema_less_run_gives_its_params(tmp_path):
    """An EMA-less run writes ``ema_params: {}``: prefer_ema then takes
    ``params``, as it does for every ported model the dispatcher maps."""
    d = RESUNET
    params = jax_params(jax_get_model(config_from_dict(d)),
                        (1, 32, 32, 32, 1), seed=3)
    path = tmp_path / "fold_0_latest.ckpt"
    write_jax_checkpoint(path, d, params, ema=False)
    cfg = config_from_dict(d)
    got = read_state_dict(str(path), prefer_ema=True, cfg=cfg)
    want = state_dict_from_jax(cfg, {"params": params})
    assert got.keys() == want.keys()
    for k, t in want.items():
        torch.testing.assert_close(got[k], t, rtol=0, atol=0, msg=k)


def test_trainer_init_model_takes_a_jax_checkpoint(tmp_path):
    """``--pretrain`` with a JAX ``.ckpt`` as ``init_model``: the model and
    its EMA copy start from the file's EMA params."""
    d = dict(RESUNET, pretrain=True)
    jm = jax_get_model(config_from_dict(d))
    params = jax_params(jm, (1, 32, 32, 32, 1), seed=4)
    path = tmp_path / "jax_best.ckpt"
    state = write_jax_checkpoint(path, d, params)
    cfg = config_from_dict(d, init_model=str(path))
    t_state = create_train_state(get_model(cfg, device="cpu", train=True),
                                 cfg)
    load_pretrained(cfg, t_state)
    want = state_dict_from_jax(cfg, {"params": state.ema_params})
    for sd in (t_state.model.state_dict(), t_state.ema.state_dict()):
        for k, t in want.items():
            torch.testing.assert_close(sd[k], t, rtol=0, atol=0, msg=k)


def test_refusals(tmp_path):
    """A truncated file raises ValueError naming it; an Orbax directory
    (``<path>.orbax``, or the directory itself) raises: reading it needs
    jax; a Flax file without a config raises; an unported model raises
    the dispatcher's error."""
    path = tmp_path / "fold_0_best.ckpt"
    params = jax_params(jax_get_model(config_from_dict(RESUNET)),
                        (1, 32, 32, 32, 1), seed=5)
    write_jax_checkpoint(path, RESUNET, params)
    cut = tmp_path / "cut.ckpt"
    cut.write_bytes(path.read_bytes()[:-100])
    with pytest.raises(ValueError, match="cut.ckpt"):
        read_payload(str(cut))
    orbax = tmp_path / "orbax_run.ckpt.orbax"
    orbax.mkdir()
    for p in (tmp_path / "orbax_run.ckpt", orbax):
        with pytest.raises(NotImplementedError, match="jax"):
            read_payload(str(p))
    model = get_model(config_from_dict(RESUNET), device="cpu")
    with pytest.raises(ValueError, match="config"):
        load_weights(str(path), model)
    with pytest.raises(NotImplementedError, match="ConvNeXtBlock"):
        read_state_dict(str(path), cfg=config_from_dict(
            dict(RESUNET, dimension="2d", block="ConvNeXtBlock")))
    assert os.path.exists(path)
