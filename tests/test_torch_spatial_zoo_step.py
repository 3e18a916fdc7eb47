"""H-sharded training (the 'spatial' mesh axis) of the rest of the 3D
UNet family, VNet and the 2D CNN models (ROADMAP A7b, A7c) on the CPU:
UNet++-3D, AttentionUNet-3D, VNet, UNet-2D, ResUNet-2D, UNet++-2D,
AttentionUNet-2D and MedFormer-2D, on two gloo ranks at ``mesh_shape``
[1, 2] (this file; [2, 2]: ``test_torch_spatial_zoo_step22.py``) against
one process on the same global batch, with the checks and tolerances of
``test_torch_spatial_step.py``: the first loss within LOSS_RTOL, the
DDP-reduced gradient and the parameters the same on every rank, the
gradient within GRAD_TOL of the one-process gradient's largest entry and a
two-step trajectory (SGD) within LOSS_RTOL and PARAM_TOL.

The 2D BatchNorm nets' random-init fp32 gradients are ill-conditioned
(ROADMAP C5) in a way the fp64 fallback of ``test_torch_spatial_step.py``
cannot hold: they jump with the torch thread count alone (on the CPU,
against the fp64 evaluation, at 1, 2, 4 and 8 threads: UNet++-2D
1.6e-2, 5.7e-3, 3.6e-6, 1.7e-2 in relative L2, UNet-2D 4.9e-6 to 1.2e-3,
MedFormer-2D 3.9e-5 to 8.4e-3), as a max-pool or a ReLU near a tie turns
one way or the other, so one fp32 run's error is no yardstick.  For them
the ranks also step in fp64 (``torch_dist_worker.train_steps(f64=True)``:
the same model, cuDNN's convs, the InstanceNorms in plain fp64 ops with
the group's sums), where every near-tie falls the same way on both sides: the
sharded fp64 gradient, losses and parameters within F64_PAIR_TOL of the
one-process fp64 ones.  Their fp32 losses and trajectories keep
``check_trajectory``'s fp64 fallback (F64_ERR_RATIO, the floors).

The models are small: base 4 in 3D (H 32, VNet 64: its 5^3 convs need 2
rows a slab at the deepest level), base 8 in 2D at 64^2, the 2D ones on
the 3x3 kernel route (``conv2d_kernel``; its plain version on the CPU)
with BatchNorm, as the JAX factory builds them.  VNet draws its channel
dropout: the spatial peers of a data index draw the one-process masks
(the generator of its per-(sample, channel) draws is seeded by the data
index).
"""

import pytest
import torch

from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from test_torch_spatial_step import (_l2, _max_err, batches,
                                     check_gradient, check_loss,
                                     check_trajectory)
from test_torch_threads import few_torch_threads  # noqa: F401
import torch_dist_worker as worker

#: the 3D models' recipe: ``test_torch_spatial_step.py``'s UNet-3D
#: (SingleConv, InstanceNorm, H down-scales multiplying to 16) with SGD
ZOO3D = dict(
    dataset="synthetic", dimension="3d", classes=3, in_chan=1, base_chan=4,
    block="SingleConv", norm="in",
    down_scale=[[1, 2, 2], [2, 2, 2], [2, 2, 2], [2, 2, 2]],
    kernel_size=[[1, 3, 3]] + [[3, 3, 3]] * 4, weight=[0.5, 1, 1], rlt=1,
    optimizer="sgd", base_lr=1e-2, weight_decay=0.01, ema=True,
    ema_alpha=0.99, training_size=[8, 32, 16])
#: the 2D models' recipe (``test_torch_unet2d.py``'s ZOO2D with SGD)
ZOO2D = dict(
    dataset="synthetic", dimension="2d", classes=4, in_chan=1, base_chan=8,
    training_size=[64, 64], aux_loss=False, weight=[0.5, 1.0, 1.0, 1.0],
    rlt=1, optimizer="sgd", base_lr=1e-2, weight_decay=0.01, ema=True,
    ema_alpha=0.99, conv2d_kernel=True)
CASES = {
    "unetpp3d": dict(ZOO3D, model="unet++"),
    "attention_unet3d": dict(ZOO3D, model="attention_unet"),
    # four downsamplings by 2 on every axis; 2 rows a slab at the bottom
    "vnet": dict(ZOO3D, model="vnet", training_size=[16, 64, 16]),
    "unet2d": dict(ZOO2D, model="unet", block="SingleConv"),
    "resunet2d": dict(ZOO2D, model="resunet", block="BasicBlock"),
    "unetpp2d": dict(ZOO2D, model="unet++"),
    "attention_unet2d": dict(ZOO2D, model="attention_unet"),
    # ``test_torch_medformer2d.py``'s TINY2D: B-MHA from down2 to up2,
    # semantic maps and their fusion, deep supervision
    "medformer2d": dict(
        ZOO2D, model="medformer", map_size=2, conv_block="BasicBlock",
        conv_num=[2, 1, 0, 0, 0, 1, 2, 2], trans_num=[0, 1, 1, 1, 1, 1, 0, 0],
        num_heads=[1, 4, 4, 4, 4, 4, 1, 1], expansion=2, fusion_depth=2,
        fusion_dim=64, fusion_heads=4, proj_type="depthwise", aux_loss=True,
        aux_weight=[0.5, 0.5], attn_drop=0.0, proj_drop=0.0),
}
#: the cases whose fp32 gradients two orders of summation keep within
#: GRAD_TOL of each other; the others step in fp64 too (module docstring)
WELL_CONDITIONED = ("unetpp3d", "attention_unet3d", "vnet")
#: the sharded fp64 run against the one-process fp64 run: the gradient in
#: relative L2, the second loss relative, the parameters after two steps
#: in lr.  Measured on the CPU: the 2D CNNs up to 4.0e-8, 1.1e-7 (the
#: loss is fp32) and 2.6e-8 lr; MedFormer-2D 8.8e-6, 2.2e-7 and 3.7e-6 lr (its
#: B-MHA products and semantic-map softmax stay fp32 islands).  A missing
#: halo, a wrong transpose or one slab's statistics err by 1e-2 to O(1)
#: (a BatchNorm variance taken as E[x^2] - E[x]^2 in fp32: 2e-2)
F64_PAIR_TOL = 1e-4


def zoo_runs(tmp, mesh_shape, cases=CASES) -> dict:
    """Per case of ``cases``: the payload, the one-process run, the
    ranks' runs at ``mesh_shape`` (one launch for every case) and, for the
    ill-conditioned cases, (the one-process fp64 run, the ranks' fp64
    runs)."""
    payloads = {}
    for name, d in cases.items():
        model = get_model(config_from_dict(d), device="cpu",
                          generator=torch.Generator().manual_seed(1))
        payloads[name] = dict(cfg=d, state_dict=model.state_dict(),
                              batches=batches(d))
    f64 = [name for name in cases if name not in WELL_CONDITIONED]
    ranks = worker.launch("train_steps_many", mesh_shape[0] * mesh_shape[1],
                          str(tmp), dict(runs=payloads, f64=f64, cfg=dict(
                              mesh_axes=["data", "spatial"],
                              mesh_shape=mesh_shape)))
    return {name: (p, worker.train_steps(None, p), [r[name] for r in ranks],
                   None if name not in f64 else
                   (worker.train_steps(None, p, f64=True),
                    [r[name + ":f64"] for r in ranks]))
            for name, p in payloads.items()}


def check_zoo_gradient(runs, case):
    """``check_gradient`` of a well-conditioned case; for the others the
    ranks' fp32 gradients the same on every rank, and the fp64 ones within
    F64_PAIR_TOL of the one-process fp64 gradient."""
    payload, one, ranks, f64 = runs[case]
    if f64 is None:
        check_gradient(runs, case)
        return
    for r in ranks[1:]:
        for k, g in ranks[0]["grads"].items():
            torch.testing.assert_close(r["grads"][k], g, rtol=0, atol=0)
    exact, sharded = f64
    err = _l2(sharded[0]["grads"], exact["grads"])
    assert err <= F64_PAIR_TOL, err


def check_zoo_trajectory(runs, case):
    """``check_trajectory`` (for an ill-conditioned case against the
    one-process fp64 run); and for those the sharded fp64 run's second
    loss and parameters after two steps within F64_PAIR_TOL of the
    one-process fp64 run's."""
    payload, one, ranks, f64 = runs[case]
    if f64 is None:
        check_trajectory(runs, case)
        return
    exact, sharded = f64
    check_trajectory({case: (payload, one, ranks, exact)}, case)
    lr = payload["cfg"]["base_lr"]
    for r in sharded:
        assert abs(r["losses"][-1] - exact["losses"][-1]) <= \
            F64_PAIR_TOL * abs(exact["losses"][-1]), (r["losses"],
                                                      exact["losses"])
        assert _max_err(r["params"], exact["params"]) <= F64_PAIR_TOL * lr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return zoo_runs(tmp_path_factory.mktemp("spatial_zoo12"), [1, 2])


@pytest.mark.parametrize("case", CASES)
def test_zoo_spatial_ranks_hold_the_global_loss(runs, case):
    check_loss(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_zoo_spatial_ranks_reduce_the_global_gradient(runs, case):
    check_zoo_gradient(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_zoo_spatial_ranks_follow_the_one_process_trajectory(runs, case):
    check_zoo_trajectory(runs, case)
