"""The port's sliding-window engine and prediction CLI vs ``cbim_tpu``'s.

On the CPU: the window geometry helpers against the JAX package's, both
engines on the same elementwise pseudo-model (padding, ragged window
groups), both engines on the tiny MedFormer-3D with the same
weights, and ``python -m cbim_tpu_torch.prediction --device cpu`` end to
end on a synthetic NIfTI.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.inference import engines as jax_engines
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.nifti import read_nifti, write_nifti
from cbim_tpu_torch.inference import engines
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.utils.jax_import import medformer3d_state_dict_from_jax
from test_torch_medformer import TINY, jax_medformer, jax_params
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("spatial,window", [
    ((160, 256, 256), (128, 128, 128)),     # the AMOS evaluation volume
    ((48, 64, 40), (32, 32, 32)),
    ((33, 33, 33), (32, 32, 32)),
    ((17, 90, 64), (16, 32, 32)),
])
def test_window_geometry_matches_jax(spatial, window):
    starts = engines._grid_starts(spatial, window)
    np.testing.assert_array_equal(
        starts, jax_engines._grid_starts(spatial, window))
    uniq, mult = engines._dedup_starts(starts)
    j_uniq, j_mult = jax_engines._dedup_starts(starts)
    np.testing.assert_array_equal(uniq, j_uniq)
    np.testing.assert_array_equal(mult, j_mult)
    assert engines._auto_window_batch(len(uniq)) == \
        jax_engines._auto_window_batch(len(uniq))
    mine = engines.InferenceEngine(None, 2, window)._count_map(
        spatial, uniq, mult)
    ref = jax_engines.InferenceEngine(lambda x: x, 2, window)._count_map(
        spatial, uniq, mult)
    np.testing.assert_array_equal(mine.reshape(spatial), ref.reshape(spatial))


def test_amos_volume_runs_18_unique_windows():
    uniq, mult = engines._dedup_starts(
        engines._grid_starts((160, 256, 256), (128, 128, 128)))
    assert len(uniq) == 18 and mult.sum() == 32
    assert engines._auto_window_batch(len(uniq)) == 6


def _pseudo_jax(x):
    base = x[..., 0]
    return jnp.stack([base, -base, 0.5 * base + 0.1, base * base], axis=-1)


def _pseudo_torch(x):
    base = x[:, 0]
    return torch.stack([base, -base, 0.5 * base + 0.1, base * base], dim=1)


@pytest.mark.parametrize("shape,window,wb", [
    ((20, 40, 24), (16, 16, 16), 1),
    ((10, 24, 30), (16, 16, 16), "auto"),   # D < window: padded
    ((32, 48, 48), (32, 32, 32), 4),        # ragged last group
])
def test_sliding_window_matches_jax_on_pseudo_model(shape, window, wb):
    vol = np.random.default_rng(7).random((1, *shape, 1), np.float32)
    ref = jax_engines.InferenceEngine(_pseudo_jax, 4, window, window_batch=wb
                                      ).sliding_window(jnp.asarray(vol))
    got = engines.InferenceEngine(_pseudo_torch, 4, window, window_batch=wb
                                  ).sliding_window(torch.from_numpy(vol))
    assert got.shape == (1, *shape, 4)
    # same windows, same fp32 sums in the same order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_whole_image_matches_jax_on_pseudo_model():
    vol = np.random.default_rng(1).random((2, 8, 12, 10, 1), np.float32)
    ref = jax_engines.InferenceEngine(_pseudo_jax, 4).whole_image(
        jnp.asarray(vol))
    got = engines.InferenceEngine(_pseudo_torch, 4).whole_image(
        torch.from_numpy(vol))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_sliding_window_matches_jax_on_tiny_medformer():
    d = dict(TINY, act="relu", window_size=[32, 32, 32])
    jm = jax_medformer(d)
    params = jax_params(jm, (1, 32, 32, 32, 1), seed=4)
    cfg = config_from_dict(d)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(medformer3d_state_dict_from_jax(params, cfg))
    # 48x64x40 under a 32^3 window: clamped edges and repeated starts on
    # every axis (24 visits, 12 unique windows, 2 groups of 6)
    vol = np.random.default_rng(2).normal(size=(1, 48, 64, 40, 1)).astype(np.float32)

    def apply_fn(v, x):
        return jm.apply(v, x, train=False)[0]

    ref = jax_engines.InferenceEngine(
        apply_fn, 3, (32, 32, 32), window_batch="auto",
        variables={"params": params}).sliding_window(jnp.asarray(vol))
    got = engines.make_engine(model, cfg).sliding_window(torch.from_numpy(vol))
    # probabilities of fp32 forwards that differ only in summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_prediction_cli_end_to_end(tmp_path):
    yaml = pytest.importorskip("yaml")
    cfg = dict(TINY, act="relu", training_size=[32, 32, 32])
    cfg_root = tmp_path / "configs"
    (cfg_root / "synthetic").mkdir(parents=True)
    with open(cfg_root / "synthetic" / "medformer_3d.yaml", "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.items()
                        if k not in ("dataset", "model", "dimension")}, f)
    weights = tmp_path / "w.pth"
    torch.save(get_model(config_from_dict(cfg), device="cpu",
                         generator=torch.Generator().manual_seed(0))
               .state_dict(), weights)
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    img = np.random.default_rng(0).normal(size=(20, 40, 36)).astype(np.float32)
    write_nifti(str(in_dir / "case.nii.gz"), img, spacing=(2.0, 1.2, 1.2))

    proc = subprocess.run(
        [sys.executable, "-m", "cbim_tpu_torch.prediction", "--dataset",
         "synthetic", "--model", "medformer", "--dimension", "3d", "--load",
         str(weights), "--img_path", str(in_dir), "--save_path",
         str(out_dir), "--target_spacing", "1.5,1.5,1.5", "--config_root",
         str(cfg_root), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "case.nii.gz done" in proc.stdout
    pred = read_nifti(str(out_dir / "case.nii.gz"))
    assert pred.data.shape == img.shape and pred.data.dtype == np.uint8
    assert pred.data.max() < cfg["classes"]
    assert pred.spacing == pytest.approx((2.0, 1.2, 1.2))


def test_prediction_refuses_what_is_not_ported(tmp_path):
    from cbim_tpu_torch import prediction
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            prediction.main(["--img_path", str(tmp_path), "--device", "cuda"])
    flax_ckpt = tmp_path / "model.ckpt"
    flax_ckpt.write_bytes(b"\x83\xa5epoch\x01")   # msgpack, cut short
    with pytest.raises(ValueError, match="model.ckpt.*truncated"):
        prediction.main(["--img_path", str(tmp_path), "--load",
                         str(flax_ckpt), "--device", "cpu", "--dataset",
                         "synthetic", "--model", "medformer"],
                        cfg=config_from_dict(dict(TINY,
                                                  training_size=[32] * 3)))
    with pytest.raises(ValueError, match="fusion"):
        engines.make_engine(torch.nn.Conv3d(1, 2, 1), config_from_dict(
            dict(TINY, window_fusion="max")))
