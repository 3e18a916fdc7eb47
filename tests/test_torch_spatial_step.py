"""H-sharded training (the 'spatial' mesh axis) of MedFormer-3D, UNet-3D
and ResUNet-3D on the CPU: gloo ranks at ``mesh_shape`` [1, 2] (this file)
and [2, 2] (``test_torch_spatial_step22.py``) against one process on the
same global batch.  The rest of the 3D UNet family, VNet and the 2D
models: ``test_torch_spatial_zoo_step.py``.

Each rank steps through ``make_train_step`` on its data index's rows and
its H slab of them (``torch_dist_worker.rank_batch``); the one-process run
steps on the whole batch.  The ranks must hold the one-process loss
(LOSS_RTOL), the same DDP-reduced gradient and parameters on every rank,
and:

- UNet-3D (``tests/test_parallel.py``'s SingleConv recipe, H widened to 32
  so that every level's slab is whole), with InstanceNorm and with
  BatchNorm: the gradient within GRAD_TOL of the one-process gradient's
  largest entry, a two-step trajectory (AdamW; SGD for the BatchNorm
  twin: losses within LOSS_RTOL, parameters within PARAM_TOL * lr), and
  BatchNorm's running statistics after the first step (STATS_TOL);
- ResUNet-3D (BasicBlock, InstanceNorm) and MedFormer-3D (remat, aux
  loss): their random-init fp32 gradients are ill-conditioned (ROADMAP C5:
  the one-process fp32 gradient errs against fp64 by 1.8e-2 and 4.8e-5 in
  L2 here), so the two sides differ by more than GRAD_TOL in either order
  of the sums.  Both are held against the one-process port's fp64
  evaluation (``exact_steps``, as ``test_torch_unet2d.py`` does): the
  sharded run's error no more than F64_ERR_RATIO times the one-process
  run's, or a floor, for the gradient (relative L2), the second step's
  loss and the parameters after two steps.  Their trajectories take SGD:
  AdamW's first step moves every entry by about lr whatever its
  gradient's size, so an entry whose true gradient lies below fp32's noise
  moves by +-lr at random on either side, while SGD's update is linear in
  the gradient and shows the gradient's own error.
"""

import numpy as np
import pytest
import torch

from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from test_torch_threads import few_torch_threads  # noqa: F401
import torch_dist_worker as worker

#: ``tests/test_parallel.py``'s UNet-3D recipe at H 32 (its H down-scales
#: multiply to 16: a slab of 16 rows at s = 2)
UNET = dict(
    dataset="synthetic", model="unet", dimension="3d", classes=3,
    in_chan=1, base_chan=4, block="SingleConv", norm="in",
    down_scale=[[1, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2]],
    kernel_size=[[1, 3, 3]] + [[3, 3, 3]] * 4,
    weight=[0.5, 1, 1], rlt=1, optimizer="adamw", base_lr=1e-3,
    betas=[0.9, 0.999], weight_decay=0.01, ema=True, ema_alpha=0.99,
    training_size=[8, 32, 16])
RESUNET = dict(UNET, model="resunet", block="BasicBlock", optimizer="sgd",
               base_lr=1e-2)
#: the same UNet-3D with BatchNorm: its training statistics cross the
#: slabs in ``global_batch_norm``'s world-group sums.  SGD: AdamW's first
#: step moves an entry by about lr whatever its gradient's size, and the
#: gradients of the parameters a BatchNorm follows (true value 0) are
#: rounding noise
UNET_BN = dict(UNET, norm="bn", optimizer="sgd", base_lr=1e-2)
#: a narrow MedFormer-3D with the flagship's structure: BasicBlock,
#: InstanceNorm + GELU, B-MHA and map fusion, remat of every stage, deep
#: supervision
MEDFORMER = dict(
    dataset="synthetic", model="medformer", dimension="3d", classes=3,
    in_chan=1, base_chan=4, chan_num=[8, 16, 16, 24, 16, 16, 8, 4],
    map_size=[2, 2, 2], conv_block="BasicBlock",
    conv_num=[2, 1, 0, 0, 0, 1, 2, 2], trans_num=[0, 1, 1, 1, 1, 1, 0, 0],
    num_heads=[1, 2, 2, 2, 2, 2, 1, 1], fusion_depth=1, fusion_dim=16,
    fusion_heads=2, expansion=2, proj_type="depthwise", norm="in",
    act="gelu", kernel_size=[[3, 3, 3]] * 5, down_scale=[[2, 2, 2]] * 4,
    aux_loss=True, aux_weight=[0.5, 0.5], remat=True, weight=[0.5, 1, 1],
    rlt=1, optimizer="sgd", base_lr=1e-2, weight_decay=0.01, ema=True,
    ema_alpha=0.99, training_size=[16, 32, 16])
CASES = {"unet": UNET, "unet_bn": UNET_BN, "resunet": RESUNET,
         "medformer": MEDFORMER}
#: the cases whose fp32 gradients two orders of summation keep within
#: GRAD_TOL of each other
WELL_CONDITIONED = ("unet", "unet_bn")
#: BatchNorm's running statistics after the first step (fp32 sums of the
#: slabs' partial sums against one process's two-pass variance)
STATS_TOL = 1e-5
#: the global batch (one row a data index at [2, 2]) and the steps
BATCH, STEPS = 2, 2
#: the first loss, relative; a gradient against the one-process
#: gradient's largest entry; the parameters after two AdamW steps, in lr
#: (AdamW moves an entry by about lr a step whatever its gradient's size)
LOSS_RTOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 0.05
#: the ill-conditioned cases against the fp64 evaluation: the sharded
#: run's error at most F64_ERR_RATIO times the one-process fp32 run's
#: (``test_torch_unet2d.py``'s ratio), or the floors, whichever is larger:
#: the gradient's relative L2, the second loss relative, the parameters'
#: largest error in lr.  Measured here, the sharded runs err by up to
#: 1.5e-4, 1.5e-5 and 0.71 lr (MedFormer-3D at [2, 2] and [1, 2]); the
#: one-process run by 4.8e-5 to 1.8e-2, 2e-7 to 2e-4 and 0.02 to 4.8 lr,
#: with the thread count and the model (its plain InstanceNorm backward
#: takes fp32 means over every voxel, where a slab's means meet in fp64).
#: A missing halo or a wrong transpose errs by O(1) of a tensor.
F64_ERR_RATIO = 2.0
F64_FLOORS = dict(grad=1e-3, loss=1e-4, params=2.0)


def batches(d, seed=0):
    rng = np.random.RandomState(seed)
    shape = (BATCH, *d["training_size"])
    return [(rng.rand(*shape, 1).astype(np.float32),
             rng.randint(0, d["classes"], shape).astype(np.int64))
            for _ in range(STEPS)]


def exact_steps(payload) -> dict:
    """The one-process steps of ``torch_dist_worker.train_steps`` in fp64
    (``f64=True``): the model in fp64 with its convs on cuDNN's route (the
    kernels' plain versions take fp32 and bf16 only) and its InstanceNorms
    in plain torch ops; the loss itself in fp32, as the port computes
    it."""
    return worker.train_steps(None, payload, f64=True)


def spatial_runs(tmp, mesh_shape) -> dict:
    """Per case: the payload, the one-process run, the ranks' runs at
    ``mesh_shape`` (one launch for every case) and, for the
    ill-conditioned cases, the fp64 evaluation."""
    payloads = {}
    for name, d in CASES.items():
        model = get_model(config_from_dict(d), device="cpu",
                          generator=torch.Generator().manual_seed(1))
        payloads[name] = dict(cfg=d, state_dict=model.state_dict(),
                              batches=batches(d))
    ranks = worker.launch("train_steps_many", mesh_shape[0] * mesh_shape[1],
                          str(tmp), dict(runs=payloads, cfg=dict(
                              mesh_axes=["data", "spatial"],
                              mesh_shape=mesh_shape)))
    return {name: (p, worker.train_steps(None, p), [r[name] for r in ranks],
                   None if name in WELL_CONDITIONED else exact_steps(p))
            for name, p in payloads.items()}


def _l2(grads, ref) -> float:
    num = sum(float((grads[k].double() - r).square().sum())
              for k, r in ref.items())
    return (num / sum(float(r.square().sum()) for r in ref.values())) ** 0.5


def _max_err(params, ref) -> float:
    return max(float((params[k].double() - r.double()).abs().max())
               for k, r in ref.items())


def check_loss(runs, case):
    """Every rank holds the one-process first loss of the global batch."""
    _, one, ranks, _ = runs[case]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"][0], one["losses"][0],
                               rtol=LOSS_RTOL)


def check_gradient(runs, case):
    """The DDP-reduced gradient, the same on every rank: within GRAD_TOL
    of the one-process gradient's largest entry, or for the
    ill-conditioned cases no farther from the fp64 evaluation than
    F64_ERR_RATIO times the one-process run."""
    _, one, ranks, exact = runs[case]
    for r in ranks[1:]:
        for k, g in ranks[0]["grads"].items():
            torch.testing.assert_close(r["grads"][k], g, rtol=0, atol=0)
    got = ranks[0]["grads"]
    if exact is None:
        top = max(float(g.abs().max()) for g in one["grads"].values())
        for k, g in one["grads"].items():
            err = float((got[k] - g).abs().max())
            assert err <= GRAD_TOL * top, (k, err, top)
        return
    sharded, single = _l2(got, exact["grads"]), _l2(one["grads"],
                                                     exact["grads"])
    assert sharded <= max(F64_FLOORS["grad"], F64_ERR_RATIO * single), \
        (sharded, single)


def check_trajectory(runs, case):
    """Two steps: the second loss and the parameters, the same on every
    rank, against the one-process run (UNet-3D) or the fp64 evaluation."""
    payload, one, ranks, exact = runs[case]
    for r in ranks[1:]:
        for k, p in ranks[0]["params"].items():
            torch.testing.assert_close(r["params"][k], p, rtol=0, atol=0)
    got = ranks[0]
    lr = payload["cfg"]["base_lr"]
    if exact is None:
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=LOSS_RTOL)
        assert _max_err(got["params"], one["params"]) <= PARAM_TOL * lr
        return
    ref = exact["losses"][-1]
    sharded = abs(got["losses"][-1] - ref)
    single = abs(one["losses"][-1] - ref)
    assert sharded <= max(F64_FLOORS["loss"] * abs(ref),
                          F64_ERR_RATIO * single), (sharded, single)
    sharded = _max_err(got["params"], exact["params"])
    single = _max_err(one["params"], exact["params"])
    assert sharded <= max(F64_FLOORS["params"] * lr, F64_ERR_RATIO * single), \
        (sharded / lr, single / lr)


def check_batchnorm_statistics(runs):
    """The BatchNorm model's running mean and variance after the first
    step, on every rank, are the one-process ones: each BatchNorm
    normalised with the whole batch's statistics, every slab's voxels
    counted."""
    _, one, ranks, _ = runs["unet_bn"]
    assert any(k.endswith("running_var") for k in one["buffers"])
    for k, b in one["buffers"].items():
        if b.dtype.is_floating_point:
            for r in ranks:
                torch.testing.assert_close(r["buffers"][k], b,
                                           rtol=STATS_TOL, atol=STATS_TOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spatial_runs(tmp_path_factory.mktemp("spatial12"), [1, 2])


def test_spatial_ranks_keep_the_global_batchnorm_statistics(runs):
    check_batchnorm_statistics(runs)


@pytest.mark.parametrize("case", CASES)
def test_spatial_ranks_hold_the_global_loss(runs, case):
    check_loss(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_spatial_ranks_reduce_the_global_gradient(runs, case):
    check_gradient(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_spatial_ranks_follow_the_one_process_trajectory(runs, case):
    check_trajectory(runs, case)
