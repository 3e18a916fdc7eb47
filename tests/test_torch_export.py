"""The port's serving artifacts (``cbim_tpu_torch/inference/export.py``, the
counterpart of ``cbim_tpu/inference/export.py``): round trips against the
port's live engine on the CPU, the export CLI, loading without the model
code, and the sliding-window artifact against the JAX package's
``export_sliding_window`` on the same weights (the counterparts of
``tests/test_export.py``).

A CPU artifact calls the ``cbim`` ops, whose CPU implementations are the
plain versions the live engine runs, so its programs equal the live ones
bit for bit.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)
from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.inference.export import export_sliding_window as jax_export_sw
from cbim_tpu.inference.export import load_exported as jax_load
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.inference.engines import make_engine
from cbim_tpu_torch.inference.export import (export_sliding_window,
                                             export_whole_image,
                                             export_window_forward,
                                             load_exported)
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.utils.jax_import import unet3d_state_dict_from_jax
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: ``tests/test_export.py``'s config: a tiny UNet-3D (base 4, SingleConv,
#: InstanceNorm, a 1x3x3 first level) on an 8 x 16 x 16 window
TINY = dict(
    dataset="synthetic", model="unet", dimension="3d", classes=3, in_chan=1,
    base_chan=4, block="SingleConv", norm="in",
    down_scale=[[1, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2]],
    kernel_size=[[1, 3, 3], [3, 3, 3], [3, 3, 3], [3, 3, 3], [3, 3, 3]],
    training_size=[8, 16, 16], batch_size=1, ema=False, sliding_window=True,
    window_size=[8, 16, 16])
#: a volume that needs padding on no axis and runs several window groups,
#: and one smaller than the window on two axes (``tests/test_export.py``)
VOLUME, SMALL = (10, 20, 24), (6, 12, 20)
#: the window forward against the live forward: ``tests/test_export.py``'s
#: tolerance for an artifact against the unjitted apply
WF_RTOL, WF_ATOL = 2e-5, 1e-6
#: the port's artifact against the JAX package's on the same weights: the
#: engine parity tolerance of ``tests/test_torch_inference.py`` (the same
#: windows, the same fp32 sums; the two packages' convolutions sum in
#: other orders, 9.8e-7 at most on this volume)
JAX_RTOL = JAX_ATOL = 1e-6


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's tiny UNet-3D and its variables (PRNG key 0), as
    ``tests/test_export.py`` builds them."""
    cfg = jax_config(TINY)
    model = jax_get_model(cfg)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 8, 16, 16, 1)), train=False)
    return cfg, model, variables


@pytest.fixture(scope="module")
def port(jax_side):
    """The port's UNet-3D with the JAX variables carried across."""
    cfg = config_from_dict(TINY)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(unet3d_state_dict_from_jax(jax_side[2], cfg))
    return cfg, model


@pytest.fixture(scope="module")
def sw_artifact(port):
    """The sliding-window artifact of VOLUME at window batch 2."""
    cfg, model = port
    return export_sliding_window(model, cfg, VOLUME, window_batch=2,
                                 device="cpu")


def test_window_forward_roundtrip(port):
    cfg, model = port
    data = export_window_forward(model, cfg, (8, 16, 16), 1, batch=2,
                                 device="cpu")
    assert isinstance(data, bytes) and len(data) > 0
    x = torch.from_numpy(_x((2, 8, 16, 16, 1), 0))
    got = load_exported(data)(x)
    with torch.inference_mode():
        want = torch.softmax(model(x.movedim(-1, 1).contiguous(
            memory_format=torch.channels_last_3d)).float(), 1).movedim(1, -1)
    assert got.shape == (2, 8, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=WF_RTOL,
                               atol=WF_ATOL)


def test_whole_image_roundtrip(port):
    cfg, model = port
    fn = load_exported(export_whole_image(model, cfg, (8, 16, 24), 1,
                                          device="cpu"))
    x = torch.from_numpy(_x((1, 8, 16, 24, 1), 3))
    np.testing.assert_array_equal(
        fn(x).numpy(), make_engine(model, cfg).whole_image(x).numpy())


def test_sliding_window_roundtrip_matches_engine(port, sw_artifact):
    cfg, model = port
    x = torch.from_numpy(_x((1, *VOLUME, 1), 1))
    got = load_exported(sw_artifact)(x)
    want = make_engine(model, cfg, window_batch=2).sliding_window(x)
    assert got.shape == (1, *VOLUME, 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sliding_window_export_pads_small_volume(port):
    """A raw volume smaller than the window is padded inside the program
    and cropped back."""
    cfg, model = port
    fn = load_exported(export_sliding_window(model, cfg, SMALL,
                                             window_batch=1, device="cpu"))
    x = torch.from_numpy(_x((1, *SMALL, 1), 2))
    got = fn(x)
    assert got.shape == (1, *SMALL, 3)
    np.testing.assert_array_equal(
        got.numpy(),
        make_engine(model, cfg, window_batch=1).sliding_window(x).numpy())


def test_sliding_window_export_gaussian_fusion(port):
    """``window_fusion: gaussian``: the importance map and the weighted
    count map go into the program as constants."""
    _, model = port
    cfg = config_from_dict(dict(TINY, window_fusion="gaussian"))
    fn = load_exported(export_sliding_window(model, cfg, VOLUME,
                                             window_batch=3, device="cpu"))
    x = torch.from_numpy(_x((1, *VOLUME, 1), 4))
    want = make_engine(model, cfg, window_batch=3).sliding_window(x)
    uniform = make_engine(model, config_from_dict(TINY),
                          window_batch=3).sliding_window(x)
    got = fn(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not torch.equal(got, uniform)


def test_sliding_window_artifact_matches_jax_export(jax_side, sw_artifact):
    """The same weights and volume through the JAX package's
    ``export_sliding_window`` artifact and the port's."""
    cfg, model, variables = jax_side
    x = _x((1, *VOLUME, 1), 1)
    ref = np.asarray(jax_load(jax_export_sw(model, variables, cfg, VOLUME,
                                            window_batch=2))(jnp.asarray(x)))
    got = load_exported(sw_artifact)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, *VOLUME, 3)
    np.testing.assert_allclose(got, ref, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_load_needs_no_model_code(tmp_path, sw_artifact):
    """A fresh interpreter loads and runs the artifact with only the
    kernels' ops registered: no module of ``cbim_tpu_torch.models``, no
    config, no checkpoint."""
    path = tmp_path / "sw.pt2"
    path.write_bytes(sw_artifact)
    script = (
        "import sys, torch\n"
        "from cbim_tpu_torch.inference.export import load_exported\n"
        "torch.set_num_threads(2)\n"
        f"fn = load_exported(open({str(path)!r}, 'rb').read())\n"
        f"out = fn(torch.zeros(1, {', '.join(map(str, VOLUME))}, 1))\n"
        "print(tuple(out.shape), float(out.sum(-1).mean()))\n"
        "bad = [m for m in sys.modules if m.startswith("
        "('cbim_tpu_torch.models', 'cbim_tpu_torch.config', 'jax', "
        "'cbim_tpu.'))]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    shape, total = r.stdout.split(")")
    assert shape + ")" == str((1, *VOLUME, 3))
    assert abs(float(total) - 1.0) < 1e-5


def test_export_cli(tmp_path):
    """``python -m cbim_tpu_torch.tools.export_model`` end to end from a
    saved port checkpoint (the trainer's ``.ckpt``, EMA weights), through a
    config the CLI loads."""
    yaml = pytest.importorskip("yaml")
    from cbim_tpu_torch.training.checkpoint import save_checkpoint
    from cbim_tpu_torch.training.train_state import create_train_state
    d = dict(TINY, optimizer="adamw", base_lr=1e-3, betas=[0.9, 0.999],
             weight_decay=0.01, weight=[0.5, 1, 1], ema=True)
    cfg_dir = tmp_path / "configs" / "synthetic"
    cfg_dir.mkdir(parents=True)
    with open(cfg_dir / "unet_3d.yaml", "w") as f:
        yaml.safe_dump({k: v for k, v in d.items()
                        if k not in ("dataset", "model", "dimension")}, f)
    cfg = config_from_dict(d)
    state = create_train_state(
        get_model(cfg, device="cpu", train=True,
                  generator=torch.Generator().manual_seed(0)), cfg)
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, state, epoch=1)

    out = str(tmp_path / "m.pt2")
    r = subprocess.run(
        [sys.executable, "-m", "cbim_tpu_torch.tools.export_model",
         "--dataset", "synthetic", "--model", "unet", "--dimension", "3d",
         "--load", ckpt, "--out", out, "--device", "cpu",
         "--config_root", str(tmp_path / "configs"), "--batch", "2"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "window-forward (8, 16, 16) x2" in r.stdout
    x = torch.from_numpy(_x((2, 8, 16, 16, 1), 5))
    probs = load_exported(open(out, "rb").read())(x)
    ema = get_model(cfg, device="cpu")
    ema.load_state_dict(state.ema.state_dict())
    with torch.inference_mode():
        want = torch.softmax(ema(x.movedim(-1, 1).contiguous(
            memory_format=torch.channels_last_3d)).float(), 1).movedim(1, -1)
    assert probs.shape == (2, 8, 16, 16, 3)
    np.testing.assert_allclose(probs.numpy(), want.numpy(), rtol=WF_RTOL,
                               atol=WF_ATOL)
