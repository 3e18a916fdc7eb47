"""The port's sharded inference engines and multi-process ``validate`` on
the CPU, against their one-process results and the JAX package's sharded
sweep.

Two gloo ranks (``torch_dist_worker``) run ``whole_image_sharded`` and
``sliding_window_slices_sharded`` on a 2D BatchNorm UNet (5 slices: the
rows padded to 6) and ``sliding_window_sharded`` on a 3D InstanceNorm UNet
(11 window groups of 3, the last short: the ranks take 6 and 5); each
equals its unsharded method within 1e-6 (fp32: only the order of the
overlapping windows' sums moves), and the 3D sweep equals the JAX package's
``sliding_window_sharded`` on a 2-device mesh within the forward parity
tests' 1e-4.  ``validate`` runs as one node of two ranks (each volume's
sweep sharded) and as two nodes of one rank (the volumes strided): every
rank returns the one-process result, Dice within 1e-6, ASD and HD95 within
1e-9 relative.
"""

import jax
import numpy as np
import pytest
import torch

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.inference.engines import make_engine as jax_make_engine
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.inference.engines import _dedup_starts, _grid_starts
from cbim_tpu_torch.models import get_model
from test_torch_parallel_train import BN2D, IN3D
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401
import torch_dist_worker as worker

W = 2
#: the 3D model's sliding window over a 12 x 40 x 36 volume (32 windows
#: in groups of 3), and the Synthetic3D split its validation takes (two
#: 12 x 40 x 36 test volumes)
SW3D = dict(IN3D, window_size=[8, 16, 16], sliding_window=True,
            window_batch=3, synthetic_cases=6, synthetic_shape=[12, 40, 36],
            k_fold=3, split_seed=0)
#: the 2D model's window (slices of 48 x 64) and the Synthetic2D split its
#: validation takes (two 6 x 40 x 40 test volumes, whole image)
SW2D = dict(BN2D, window_size=[32, 32], synthetic_cases=4, k_fold=2,
            split_seed=1)
PROB_ATOL, JAX_PROB_ATOL = 1e-6, 1e-4
DICE_ATOL, DISTANCE_RTOL = 1e-6, 1e-9


def _state_dict(d, seed):
    return get_model(config_from_dict(d), device="cpu",
                     generator=torch.Generator().manual_seed(seed)
                     ).state_dict()


@pytest.fixture(scope="module")
def payload():
    rng = np.random.default_rng(5)
    return dict(cfg3d=SW3D, sd3d=_state_dict(SW3D, 2),
                cfg2d=SW2D, sd2d=_state_dict(SW2D, 3),
                volume=rng.normal(size=(1, 12, 40, 36, 1)).astype(np.float32),
                slices=rng.normal(size=(5, 48, 64, 1)).astype(np.float32))


@pytest.fixture(scope="module")
def engines(payload, tmp_path_factory):
    """The one-process methods' results and the two ranks' sharded ones."""
    one = worker.sharded_engines(None, payload)
    ranks = worker.launch("sharded_engines", W,
                          str(tmp_path_factory.mktemp("engines")), payload)
    return one, ranks


def test_the_sweep_splits_unevenly():
    """The 3D sweep's window groups do not divide over the ranks, so one
    rank's share is short, and its last group is short too (and the 2D
    rows are padded: 5 slices)."""
    starts, _ = _dedup_starts(_grid_starts((12, 40, 36), (8, 16, 16)))
    groups = -(-len(starts) // SW3D["window_batch"])
    assert groups % W == 1 and len(starts) % SW3D["window_batch"], \
        (len(starts), groups)


@pytest.mark.parametrize("method", ["whole_image", "sliding_window",
                                    "sliding_window_slices"])
def test_sharded_engine_equals_unsharded(engines, method):
    """Every rank returns the whole result, the unsharded method's."""
    one, ranks = engines
    for r in ranks:
        assert r[method].shape == one[method].shape
        torch.testing.assert_close(r[method], one[method], rtol=0,
                                   atol=PROB_ATOL)


def test_sliding_window_sharded_matches_jax(payload, engines):
    """The port's 2-rank 3D sweep against ``cbim_tpu``'s
    ``sliding_window_sharded`` over a 2-device mesh, same weights (through
    ``torch_import.import_unet``) and volume."""
    _, ranks = engines
    jc = jax_config(SW3D)
    jm = jax_get_model(jc)
    params = torch_import.import_unet(
        {k: v.numpy() for k, v in payload["sd3d"].items()},
        jax_params(jm, (1, 8, 16, 16, 1), seed=0), block="SingleConv")
    engine = jax_make_engine(jm, {"params": params}, jc)
    mesh = jax_make_mesh(jc, devices=jax.devices()[:W])
    ref = np.asarray(engine.sliding_window_sharded(payload["volume"], mesh))
    np.testing.assert_allclose(ranks[0]["sliding_window"].numpy(), ref,
                               rtol=0, atol=JAX_PROB_ATOL)


@pytest.fixture(scope="module")
def validations(payload, tmp_path_factory):
    """``validate``'s one-process results, and those of each rank as one
    node of two ranks and as two nodes of one."""
    one = worker.validate_runs(None, payload)
    runs = {}
    for name, local in (("1x2", 2), ("2x1", 1)):
        runs[name] = worker.launch(
            "validate_runs", W, str(tmp_path_factory.mktemp(name)), payload,
            local_size=local)
    return one, runs


@pytest.mark.parametrize("layout", ["1x2", "2x1"])
@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_validate_across_ranks_equals_one_process(validations, layout, dim):
    """Every rank returns the one-process (dice, asd, hd), so all of them
    keep the same best epoch."""
    one, runs = validations
    dice, asd, hd = one[dim]
    assert np.isfinite(dice).any()
    for r in runs[layout]:
        got_dice, got_asd, got_hd = r[dim]
        np.testing.assert_allclose(got_dice, dice, rtol=0, atol=DICE_ATOL)
        np.testing.assert_allclose(got_asd, asd, rtol=DISTANCE_RTOL)
        np.testing.assert_allclose(got_hd, hd, rtol=DISTANCE_RTOL)
