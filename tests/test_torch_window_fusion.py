"""Gaussian window fusion (the config's ``window_fusion: gaussian``) in the
port's engines vs ``cbim_tpu``'s, on the CPU.

The importance map and the importance-weighted count map are host numpy in
both packages: equal within FUSION_ATOL.  ``sliding_window`` (3D) and
``sliding_window_slices`` (2D) run a shared small model, a 1x1 conv with
the same weights in both packages, through both engines on volumes with
clamped edges, repeated starts and padding: the fused probabilities agree
within PROB_TOL (the same windows and weights, fp32 sums in the same
order), for gaussian and uniform fusion.  The prediction CLI serves a
NIfTI with a config that sets ``window_fusion: gaussian``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.inference import engines as jax_engines
from cbim_tpu_torch import prediction
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.nifti import read_nifti, write_nifti
from cbim_tpu_torch.inference import engines
from cbim_tpu_torch.models import get_model
from test_torch_medformer import TINY
from test_torch_threads import few_torch_threads  # noqa: F401

FUSION_ATOL = 1e-7
PROB_TOL = dict(rtol=1e-6, atol=1e-6)

#: the shared model: 1x1 conv from 2 input channels to 3 classes
W = np.array([[1.0, -0.5, 0.25], [-0.75, 0.5, 1.5]], np.float32)
B = np.array([0.1, -0.2, 0.05], np.float32)


def _jax_model(x):
    return x @ W + B


def _torch_model(x):
    return (torch.einsum("bc...,ck->bk...", x, torch.from_numpy(W))
            + torch.from_numpy(B).view(1, -1, *([1] * (x.dim() - 2))))


@pytest.mark.parametrize("window", [(8, 8, 8), (5, 7, 6), (64, 64),
                                    (128, 128, 128)])
def test_importance_map_matches_jax(window):
    """nnU-Net's separable Gaussian, sigma = window / 8, scaled to 1 and
    floored at 1e-3: as the JAX engine builds it."""
    ref = jax_engines.InferenceEngine(_jax_model, 3, window,
                                      fusion="gaussian")._importance(window)
    got = engines.importance_map(window, "gaussian")
    assert got.shape == tuple(window) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref[..., 0], rtol=0, atol=FUSION_ATOL)
    assert got.max() == 1.0 and got.min() >= 1e-3
    np.testing.assert_array_equal(engines.importance_map(window, "uniform"),
                                  np.ones(window, np.float32))


@pytest.mark.parametrize("spatial,window", [
    ((20, 18, 22), (8, 8, 8)), ((160, 256, 256), (128, 128, 128)),
    ((40, 50), (16, 16))])
def test_count_map_matches_jax(spatial, window):
    """The fusion denominator: each voxel's window visits (dedup'd starts
    times their multiplicity) times the importance there."""
    uniq, mult = engines._dedup_starts(engines._grid_starts(spatial, window))
    ref = jax_engines.InferenceEngine(
        _jax_model, 3, window, fusion="gaussian")._count_map(
            spatial, uniq, mult)
    got = engines.InferenceEngine(None, 3, window,
                                  fusion="gaussian")._count_map(
        spatial, uniq, mult)
    np.testing.assert_allclose(got.reshape(spatial), ref.reshape(spatial),
                               rtol=0, atol=FUSION_ATOL)
    assert got.min() > 0


@pytest.mark.parametrize("fusion", ["gaussian", "uniform"])
@pytest.mark.parametrize("shape,window,wb", [
    ((20, 18, 22), (8, 8, 8), "auto"),
    ((6, 24, 30), (8, 16, 16), 2)])        # D < window: padded
def test_sliding_window_matches_jax(fusion, shape, window, wb):
    vol = np.random.default_rng(3).normal(size=(1, *shape, 2)).astype(
        np.float32)
    ref = jax_engines.InferenceEngine(_jax_model, 3, window, window_batch=wb,
                                      fusion=fusion).sliding_window(
        jnp.asarray(vol))
    got = engines.InferenceEngine(_torch_model, 3, window, window_batch=wb,
                                  fusion=fusion).sliding_window(
        torch.from_numpy(vol))
    assert got.shape == (1, *shape, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PROB_TOL)


@pytest.mark.parametrize("fusion", ["gaussian", "uniform"])
def test_sliding_window_slices_matches_jax(fusion):
    """The 2D slice-batch sweep: 3 slices of 40 x 27 under a 16^2 window
    (clamped edges, repeated starts) and one axis padded."""
    vol = np.random.default_rng(4).normal(size=(3, 40, 27, 2)).astype(
        np.float32)
    window = (16, 32)
    ref = jax_engines.InferenceEngine(_jax_model, 3, window,
                                      fusion=fusion).sliding_window_slices(
        jnp.asarray(vol))
    got = engines.InferenceEngine(_torch_model, 3, window,
                                  fusion=fusion).sliding_window_slices(
        torch.from_numpy(vol))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PROB_TOL)


def test_prediction_cli_takes_gaussian_fusion(tmp_path, monkeypatch):
    """``prediction.main`` with a config that sets ``window_fusion:
    gaussian``: its engine fuses by the Gaussian, and the label map is
    written on the input grid."""
    made = []
    real = engines.InferenceEngine

    class Recorded(real):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self.fusion)

    monkeypatch.setattr(engines, "InferenceEngine", Recorded)
    cfg = dict(TINY, act="relu", training_size=[32, 32, 32],
               window_fusion="gaussian")
    weights = tmp_path / "w.pth"
    torch.save(get_model(config_from_dict(cfg), device="cpu",
                         generator=torch.Generator().manual_seed(0))
               .state_dict(), weights)
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    img = np.random.default_rng(0).normal(size=(20, 40, 36)).astype(
        np.float32)
    write_nifti(str(in_dir / "case.nii.gz"), img, spacing=(2.0, 1.2, 1.2))
    seconds = prediction.main(
        ["--dataset", "synthetic", "--model", "medformer", "--dimension",
         "3d", "--load", str(weights), "--img_path", str(in_dir),
         "--save_path", str(out_dir), "--target_spacing", "1.5,1.5,1.5",
         "--device", "cpu"], cfg=config_from_dict(cfg))
    assert list(seconds) == ["case.nii.gz"] and made == ["gaussian"]
    pred = read_nifti(str(out_dir / "case.nii.gz"))
    assert pred.data.shape == img.shape and pred.data.dtype == np.uint8
    assert pred.data.max() < cfg["classes"]
