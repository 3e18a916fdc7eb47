"""Data-parallel training in the port (``cbim_tpu_torch.parallel``) on the
CPU: two gloo ranks against one process on the global batch, and against
the JAX package's step on a 2-device mesh.

The ranks are spawned processes (``torch_dist_worker``), each taking one
``make_train_step`` on its half of the global batch; the one-process run
steps on the whole batch.  The numbers must be the JAX mesh's: the global
batch's loss (ranks hold the same loss), the gradient of that loss (DDP's
mean over the ranks), and for a BatchNorm model the global batch's
statistics (the running ones equal after the step).  Two models: JAX's
``test_data_parallel_train_step_matches_single_device`` UNet-3D
(InstanceNorm) and a small UNet-2D (BatchNorm); each 2-rank step's loss
equals the JAX step's on a 2-device mesh at the same weights, and the
BatchNorm's running statistics after it equal JAX's, whose means over
the sharded batch axis are global.  The Dice case shows what
the global reduction is for: a class present in one rank's rows alone
makes the mean of per-rank Dice losses another number than the global
one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cbim_tpu.training.optim import get_optimizer as jax_get_optimizer
from cbim_tpu.training.train_state import TrainState as JaxTrainState
from cbim_tpu.training.train_state import make_train_step as jax_make_step
from cbim_tpu.utils import torch_import
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.ops import losses
from cbim_tpu_torch.utils.jax_import import unet2d_state_dict_from_jax
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401
import torch_dist_worker as worker

#: ``tests/test_parallel.py``'s data-parallel config (InstanceNorm)
IN3D = dict(
    dataset="synthetic", model="unet", dimension="3d", classes=3,
    in_chan=1, base_chan=4, block="SingleConv", norm="in",
    down_scale=[[1, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2]],
    kernel_size=[[1, 3, 3]] + [[3, 3, 3]] * 4,
    weight=[0.5, 1, 1], rlt=1, optimizer="adamw", base_lr=1e-3,
    betas=[0.9, 0.999], weight_decay=0.01, ema=True, ema_alpha=0.99,
    training_size=[8, 16, 16])
#: a small UNet-2D: BatchNorm after every conv (2^2 at the bottom level)
BN2D = dict(
    dataset="synthetic", model="unet", dimension="2d", classes=3,
    in_chan=1, base_chan=4, weight=[0.5, 1, 1], rlt=1, optimizer="adamw",
    base_lr=1e-3, betas=[0.9, 0.999], weight_decay=0.01, ema=True,
    ema_alpha=0.99, training_size=[32, 32])
CASES = {"in3d": IN3D, "bn2d": BN2D}
#: the global batch and the ranks
BATCH, W = 8, 2
#: the tolerances: the losses relative, each gradient tensor against the
#: largest entry of the whole gradient (a conv bias before a BatchNorm has
#: a true gradient of 0: its entries are rounding noise, at most about
#: 1e-3 of the largest), the running statistics (fp32 sums of W partial
#: sums: the one-pass E[x^2] - E[x]^2 of Flax's BatchNorm against torch's
#: two-pass variance on one process)
LOSS_RTOL, GRAD_TOL, STATS_TOL = 1e-6, 1e-5, 1e-5
#: the first loss against JAX's on its 2-device mesh (the single-device
#: parity tests' first-loss tolerance)
JAX_LOSS_RTOL = 1e-5


def _batches(d, seed=0, steps=2):
    rng = np.random.RandomState(seed)
    shape = (BATCH, *d["training_size"])
    return [(rng.rand(*shape, 1).astype(np.float32),
             rng.randint(0, d["classes"], shape).astype(np.int64))
            for _ in range(steps)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the payload, the one-process run and the two ranks'
    runs."""
    out = {}
    tmp = tmp_path_factory.mktemp("ddp")
    for name, d in CASES.items():
        model = get_model(config_from_dict(d), device="cpu",
                          generator=torch.Generator().manual_seed(1))
        payload = dict(cfg=d, state_dict=model.state_dict(),
                       batches=_batches(d))
        one = worker.train_steps(None, payload)
        (tmp / name).mkdir()
        ranks = worker.launch("train_steps", W, str(tmp / name), payload)
        out[name] = (payload, one, ranks)
    return out


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_hold_the_global_batch_loss(runs, case):
    """Both ranks return the one-process loss of the global batch."""
    _, one, ranks = runs[case]
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], one["losses"][0],
                                   rtol=LOSS_RTOL)
    assert ranks[0]["losses"] == ranks[1]["losses"]


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_reduce_the_global_batch_gradient(runs, case):
    """DDP's reduced gradients: equal on both ranks, and each tensor
    within GRAD_TOL of the largest entry of the one-process gradient."""
    _, one, ranks = runs[case]
    top = max(float(g.abs().max()) for g in one["grads"].values())
    for k, g in one["grads"].items():
        torch.testing.assert_close(ranks[0]["grads"][k],
                                   ranks[1]["grads"][k], rtol=0, atol=0)
        err = float((ranks[0]["grads"][k] - g).abs().max())
        assert err <= GRAD_TOL * top, (k, err, top)


def test_two_ranks_keep_the_global_batchnorm_statistics(runs):
    """The BatchNorm model's running mean and (biased) variance after the
    step are the one-process ones, on both ranks: each BatchNorm
    normalised with the global batch's statistics."""
    _, one, ranks = runs["bn2d"]
    stats = [k for k in one["buffers"] if k.endswith("running_var")]
    assert len(stats) > 10
    for k, b in one["buffers"].items():
        if b.dtype.is_floating_point:
            for r in ranks:
                torch.testing.assert_close(r["buffers"][k], b,
                                           rtol=STATS_TOL, atol=STATS_TOL)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_follow_the_one_process_trajectory(runs, case):
    """The second step's loss and the parameters after two AdamW steps:
    the ranks hold the same parameters, and they follow the one-process
    run (AdamW's first step moves an entry by about lr whatever the size of
    its gradient, so the parameters are held to a share of lr)."""
    payload, one, ranks = runs[case]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-5)
    lr = payload["cfg"]["base_lr"]
    for k, p in one["params"].items():
        torch.testing.assert_close(ranks[0]["params"][k],
                                   ranks[1]["params"][k], rtol=0, atol=0)
        torch.testing.assert_close(ranks[0]["params"][k], p, rtol=0,
                                   atol=0.05 * lr)


def _jax_mesh_step(d, variables, img, lab):
    """The JAX package's ``make_train_step`` on ``variables`` ({"params",
    "batch_stats"}) with the global batch sharded over a 2-device 'data'
    mesh (``tests/test_parallel.py``'s shardings): (loss, the batch
    statistics after the step)."""
    jc = jax_config(d)
    jm = jax_get_model(jc)
    tx = jax_get_optimizer(jc)
    params, stats = variables["params"], variables.get("batch_stats", {})
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), batch_stats=stats,
        ema_params=jax.tree.map(jnp.array, params),
        ema_batch_stats=jax.tree.map(jnp.array, stats))
    mesh = jax_make_mesh(jc, devices=jax.devices()[:W])
    repl, bsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    step = jax.jit(jax_make_step(jm, tx, jc),
                   in_shardings=(repl, bsh, bsh, None),
                   out_shardings=(repl, repl))
    new, loss = step(jax.device_put(state, repl), jax.device_put(img, bsh),
                     jax.device_put(lab.astype(np.int32), bsh), d["base_lr"])
    return float(loss), jax.tree.map(np.asarray, new.batch_stats)


def test_two_rank_loss_matches_the_jax_two_device_mesh(runs):
    """The InstanceNorm model: the same weights (the port's seeded init
    through ``torch_import.import_unet``) and global batch through the JAX
    step sharded over a 2-device 'data' mesh: its loss is the 2-rank
    port's."""
    payload, _, ranks = runs["in3d"]
    jm = jax_get_model(jax_config(IN3D))
    img, lab = payload["batches"][0]
    template = jax_params(jm, (1, *img.shape[1:]), seed=0)
    params = torch_import.import_unet(
        {k: v.numpy() for k, v in payload["state_dict"].items()}, template,
        block="SingleConv")
    loss, _ = _jax_mesh_step(IN3D, {"params": params}, img, lab)
    np.testing.assert_allclose(ranks[0]["losses"][0], loss,
                               rtol=JAX_LOSS_RTOL)


def test_two_rank_batchnorm_step_matches_the_jax_two_device_mesh(
        tmp_path_factory):
    """The BatchNorm model: Flax variables drawn with numpy (the initial
    batch statistics) mapped onto the port by ``unet2d_state_dict_from_jax``;
    two ranks step on the global batch, and the JAX step on a 2-device
    mesh: the same loss, and the same running mean and variance after the
    step (the port's ranks take the global batch's statistics, as GSPMD's
    sharded means do)."""
    cfg = config_from_dict(BN2D)
    jm = jax_get_model(jax_config(BN2D))
    shape = (1, *BN2D["training_size"], 1)
    params = jax_params(jm, shape, seed=4, train=False)
    with jax.ensure_compile_time_eval():
        stats = jax.eval_shape(
            lambda k, x: jm.init({"params": k}, x, train=False),
            jax.random.PRNGKey(0),
            jax.ShapeDtypeStruct(shape, jnp.float32))["batch_stats"]
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.ones if path[-1].key == "var" else np.zeros)(
            a.shape, np.float32), stats)
    variables = {"params": params, "batch_stats": stats}
    img, lab = _batches(BN2D, seed=7, steps=1)[0]
    payload = dict(cfg=BN2D, state_dict=unet2d_state_dict_from_jax(
        variables, cfg), batches=[(img, lab)])
    ranks = worker.launch("train_steps", W,
                          str(tmp_path_factory.mktemp("bnjax")), payload)
    loss, new_stats = _jax_mesh_step(BN2D, variables, img, lab)
    want = unet2d_state_dict_from_jax(
        {"params": params, "batch_stats": new_stats}, cfg)
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], loss, rtol=JAX_LOSS_RTOL)
        keys = [k for k in r["buffers"] if k.endswith(("running_mean",
                                                       "running_var"))]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(r["buffers"][k].numpy(),
                                       np.asarray(want[k]), rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=k)


@pytest.fixture(scope="module")
def dice_case(tmp_path_factory):
    """Logits and labels of a global batch of 4 in which class 2 lies in
    the last two rows alone (rank 1's), the logits a noisy one-hot of the
    labels (a good prediction), their two ranks' losses, and the
    one-process losses and Dice gradient."""
    rng = np.random.default_rng(3)
    target = rng.integers(0, 2, size=(4, 6, 6))
    target[2:, 1:4, 1:4] = 2
    logits = (4.0 * np.eye(3)[target].transpose(0, 3, 1, 2)
              + rng.normal(size=(4, 3, 6, 6))).astype(np.float32)
    payload = dict(logits=logits, target=target, weight=[0.5, 1.0, 2.0])
    ranks = worker.launch("dice_losses", W,
                          str(tmp_path_factory.mktemp("dice")), payload)
    x = torch.from_numpy(logits).requires_grad_(True)
    t = torch.from_numpy(target)
    dice = losses.dice_loss(x, t)
    dice.backward()
    w = payload["weight"]
    one = dict(dice=float(dice), grad=x.grad,
               ce=float(losses.weighted_cross_entropy(x, t, w)),
               focal=float(losses.focal_loss(x, t, alpha=w)))
    return one, ranks


def test_dice_loss_is_the_global_batch_loss(dice_case):
    """The mean of the ranks' own Dice losses is not the global batch's
    (on rank 0, class 2 has no tp: its Dice term is 1 where the global
    one is small; 0.234 against 0.118); with the group
    every rank holds the one-process loss, and the ranks' gradients,
    concatenated, are W times the one-process gradient (DDP's mean takes
    the W back)."""
    one, ranks = dice_case
    local = np.mean([r["local_dice"] for r in ranks])
    assert local - one["dice"] > 0.1, (local, one["dice"])
    for r in ranks:
        np.testing.assert_allclose(r["dice"], one["dice"], rtol=LOSS_RTOL)
    grad = torch.cat([r["grad"] for r in ranks]) / W
    torch.testing.assert_close(grad, one["grad"], rtol=0,
                               atol=GRAD_TOL * float(one["grad"].abs().max()))


@pytest.mark.parametrize("name", ["ce", "focal"])
def test_weighted_losses_are_the_global_batch_loss(dice_case, name):
    """The class-weighted cross entropy (sum(w[t] ce) / sum(w[t])) and the
    focal loss's mean, with the group: the one-process losses."""
    one, ranks = dice_case
    for r in ranks:
        np.testing.assert_allclose(r[name], one[name], rtol=LOSS_RTOL)
