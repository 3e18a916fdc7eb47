"""H-sharded training against the JAX package: the port's loss on two
gloo ranks at ``mesh_shape`` [1, 2] ('data', 'spatial') equals the JAX
package's train step on a [1, 2] mesh of two host devices, jitted as
``cbim_tpu/training/trainer.py:57-95`` jits it (the image sharded on H,
the Pallas kernels off), on the same weights (the port's seeded init
through ``torch_import.import_unet``) and global batch: UNet-3D
(``tests/test_parallel.py``'s recipe at H 32) and ResUNet-3D.

MedFormer-3D: ``test_torch_spatial_jax_medformer.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.ops._backend import set_pallas_disabled
from cbim_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cbim_tpu.training.optim import get_optimizer as jax_get_optimizer
from cbim_tpu.training.train_state import TrainState as JaxTrainState
from cbim_tpu.training.train_state import make_train_step as jax_make_step
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from test_torch_spatial_step import RESUNET, UNET, batches
from test_torch_swin_train import fast_xla_compile
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401
import torch_dist_worker as worker

CASES = {"unet": UNET, "resunet": RESUNET}
MESH = dict(mesh_axes=["data", "spatial"], mesh_shape=[1, 2])
#: the single-device parity tests' first-loss tolerance
JAX_LOSS_RTOL = 1e-5


def jax_spatial_loss(d, params, img, lab, model=None,
                     batch_stats=None) -> float:
    """The JAX package's first step on ``params`` (and ``batch_stats``, the
    BatchNorm nets') of ``model`` (default: its factory's model of ``d``)
    with the global batch sharded P('data', None, 'spatial', None, None)
    in 3D, P('data', 'spatial', None, None) in 2D, over a [1, 2] mesh of
    two host devices, its Pallas kernels off, as its trainer runs it."""
    jc = jax_config(dict(d, **MESH))
    jm = model if model is not None else jax_get_model(jc)
    tx = jax_get_optimizer(jc)
    stats = batch_stats or {}
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), batch_stats=stats,
        ema_params=jax.tree.map(jnp.array, params),
        ema_batch_stats=jax.tree.map(jnp.array, stats))
    mesh = jax_make_mesh(jc, devices=jax.devices()[:2])
    repl = NamedSharding(mesh, P())
    spec = ["data", None, "spatial", None, None] if jc.dimension == "3d" \
        else ["data", "spatial", None, None]
    img_sh = NamedSharding(mesh, P(*spec))
    lab_sh = NamedSharding(mesh, P(*spec[:-1]))
    set_pallas_disabled(True)
    try:
        with fast_xla_compile():
            step = jax.jit(jax_make_step(jm, tx, jc),
                           in_shardings=(repl, img_sh, lab_sh, None),
                           out_shardings=(repl, repl))
            _, loss = step(jax.device_put(state, repl),
                           jax.device_put(img, img_sh),
                           jax.device_put(lab.astype(np.int32), lab_sh),
                           d["base_lr"])
    finally:
        set_pallas_disabled(False)
    return float(loss)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the payload and the two ranks' runs (one launch)."""
    payloads = {}
    for name, d in CASES.items():
        model = get_model(config_from_dict(d), device="cpu",
                          generator=torch.Generator().manual_seed(1))
        payloads[name] = dict(cfg=d, state_dict=model.state_dict(),
                              batches=batches(d)[:1])
    ranks = worker.launch("train_steps_many", 2,
                          str(tmp_path_factory.mktemp("spatial_jax")),
                          dict(runs=payloads, cfg=MESH))
    return {name: (p, [r[name] for r in ranks])
            for name, p in payloads.items()}


@pytest.mark.parametrize("case", CASES)
def test_spatial_loss_matches_the_jax_spatial_mesh(runs, case):
    payload, ranks = runs[case]
    d = CASES[case]
    img, lab = payload["batches"][0]
    template = jax_params(jax_get_model(jax_config(d)), (1, *img.shape[1:]),
                          seed=0)
    params = torch_import.import_unet(
        {k: v.numpy() for k, v in payload["state_dict"].items()}, template,
        block=d["block"])
    loss = jax_spatial_loss(d, params, img, lab)
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], loss, rtol=JAX_LOSS_RTOL)
