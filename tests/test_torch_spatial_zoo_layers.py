"""The layers that the 'spatial' mesh axis adds for the rest of the 3D
UNet family, VNet and the 2D CNN models (ROADMAP A7b, A7c), on the CPU:
each run on the H slabs of s = 2 and s = 4 gloo ranks against the same
layer on the whole tensor in one process, with
``test_torch_spatial_layers.py``'s tolerances and checks; H is dim 3 of a
3D case and dim 2 of a 2D one.

The cases (``torch_dist_worker.ZOO_LAYER_INPUTS``): VNet's 5^3 conv (a
halo of 2 planes, 2 rows a slab at s = 4), its down transition (the
strided ``down_conv``, no halo), its up transition (the transposed
``up_conv``) and ``ContBatchNorm`` over the world group; AttentionUNet's
gate with every InstanceNorm at C = 1 and its 3D and 2D up blocks; UNet++'s
upsample in 3D and 2D; the 2D UNet's up block (BasicBlock, BatchNorm, the
3x3 kernel route); MedFormer-2D's up block with a B-MHA block (its
semantic map: every peer's whole copy); a 2D ConvNormAct on the 3x3
kernel route with BatchNorm.  And the refusal of a VNet slab thinner than
the halo names the model and the conv's level.
"""

import pytest
import torch

from test_torch_spatial_layers import GRAD_TOL, OUT_TOL, PARAM_TOL, SLABS
from test_torch_threads import few_torch_threads  # noqa: F401
import torch_dist_worker as worker

CASES = list(worker.ZOO_LAYER_INPUTS)
#: a VNet input (B, C, D, H, W) whose slabs at s = 2 have 16 rows: one
#: row at the deepest level (down_tr256), under the 5^3 convs' halo of 2
THIN_VNET = (2, 1, 16, 32, 16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process run of every case, and the ranks' runs at each s."""
    data = {c: worker.layer_data(c) for c in CASES}
    payload = {"cases": CASES, "data": data, "thin_vnet_input": THIN_VNET}
    one = worker.spatial_layers(None, payload)
    ranks = {}
    for s in SLABS:
        tmp = tmp_path_factory.mktemp(f"spatial_zoo{s}")
        ranks[s] = worker.launch("spatial_layers_zoo", s, str(tmp), dict(
            payload, cfg=dict(mesh_axes=["data", "spatial"],
                              mesh_shape=[1, s])))
    return one, ranks


def _err(a, b) -> float:
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("s", SLABS)
@pytest.mark.parametrize("case", CASES)
def test_zoo_layer_on_h_slabs_equals_the_whole(runs, case, s):
    one, ranks = runs
    ref = one[case]
    got = [r[case] for r in ranks[s]]
    replicated = worker.REPLICATED_OUTPUTS.get(case, ())
    for i, y in enumerate(ref["outputs"]):
        if i in replicated:
            for g in got:
                assert _err(g["outputs"][i], y) <= OUT_TOL, (case, i)
        else:
            joined = torch.cat([g["outputs"][i] for g in got], y.dim() - 2)
            assert joined.shape == y.shape
            assert _err(joined, y) <= OUT_TOL, (case, i, _err(joined, y))
    for i, dx in enumerate(ref["input_grads"]):
        sharded = worker.ZOO_LAYER_INPUTS[case][i][1]
        parts = [g["input_grads"][i] for g in got]
        joined = torch.cat(parts, dx.dim() - 2) if sharded else sum(parts)
        assert _err(joined, dx) <= GRAD_TOL, (case, i, _err(joined, dx))
    top = max((float(g.abs().max()) for g in ref["param_grads"].values()),
              default=0.0)
    for k, g in ref["param_grads"].items():
        for r in got:
            err = float((r["param_grads"][k] - g).abs().max())
            assert err <= PARAM_TOL * top, (case, k, err, top)


def test_vnet_refuses_a_slab_thinner_than_its_halo(runs):
    """At s = 2 the deepest level's slab has one row: the first 5^3 conv
    there refuses it on every rank, naming VNet and the conv."""
    _, ranks = runs
    for r in ranks[2]:
        msg = r["refusal"]
        assert msg is not None
        assert "VNet down_tr256.ops.0.conv1" in msg and \
            "halo of 2 rows exceeds the slab's 1" in msg, msg
    for r in ranks[4]:
        assert r["refusal"] is not None


def test_spatial_shard_marks_strided_convs_and_refuses_the_rest():
    """Without a halo: a strided conv with kernel == stride is marked (and
    refuses a slab whose rows its stride does not divide, before any
    collective), a transposed conv of that kind stays unmarked; a conv
    with padding that is not SAME, or a transposed conv with kernel !=
    stride, is refused naming the model and the module."""
    from cbim_tpu_torch.models import vnet
    from cbim_tpu_torch.models.layers.convs import spatial_shard
    group = object()                  # the checks run before a collective
    down = spatial_shard(vnet.DownTransition(2, 1, elu=True), group)
    assert down.down_conv.spatial_group is group
    assert down.down_conv.spatial_name == "DownTransition down_conv"
    with pytest.raises(ValueError, match="DownTransition down_conv: an H "
                       "slab of 5 rows does not divide by the conv's "
                       "stride 2"):
        down.train()(torch.zeros(2, 2, 4, 5, 4))
    up = spatial_shard(vnet.UpTransition(4, 4, 1, elu=True), group)
    assert not hasattr(up.up_conv, "spatial_group")
    for bad, match in (
            (torch.nn.Conv3d(2, 2, 3, padding=0), "kernel 3, stride 1 and "
             "padding 0"),
            (torch.nn.ConvTranspose3d(2, 2, 3, stride=2), "transposed conv "
             "of kernel 3, stride 2")):
        with pytest.raises(NotImplementedError, match=match):
            spatial_shard(torch.nn.Sequential(bad), group)
