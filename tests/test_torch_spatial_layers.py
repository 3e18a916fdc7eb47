"""The 'spatial' mesh axis's layers (``cbim_tpu_torch.parallel.spatial``)
on the CPU: each layer that crosses H, run on the H slabs of s = 2 and
s = 4 gloo ranks, against the same layer on the whole tensor in one
process.

The cases (``torch_dist_worker.LAYER_INPUTS``): the halo conv on the 3^3
kernel route, a 1x3x3 conv (three rows of H: it takes a halo too), the
depthwise 3^3 conv, the fused preact conv (``conv_na``) and a plain conv,
each behind its InstanceNorm with the whole volume's statistics; the
spatial ``InstanceNormAct`` alone; an MBConv (its SE block's mean over
space); ``resize_linear`` by 2 and by 4 (the decoders' and the aux head's
upsample) and ``resize_nearest`` by 2; MedFormer's
``SemanticMapGeneration`` and B-MHA.  The ranks'
outputs, joined along H (a semantic map: each rank's whole copy), equal
the one-process outputs within OUT_TOL of the largest entry; the inputs'
gradients within GRAD_TOL, the parameters' gradients (summed over the
ranks) within PARAM_TOL.
"""

import numpy as np
import pytest
import torch

from test_torch_threads import few_torch_threads  # noqa: F401
import torch_dist_worker as worker

#: the tolerances, of the largest entry: the outputs; the inputs'
#: gradients; the parameters' gradients, whose sums over the voxels cancel
#: (the SE block's excitation: about 6e-5 at s = 4, fp32 sums in another
#: order)
OUT_TOL, GRAD_TOL, PARAM_TOL = 1e-6, 1e-5, 1e-4
CASES = list(worker.LAYER_INPUTS)
SLABS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process run of every case, and the ranks' runs at each s."""
    data = {c: worker.layer_data(c) for c in CASES}
    payload = {"cases": CASES, "data": data}
    one = worker.spatial_layers(None, payload)
    ranks = {}
    for s in SLABS:
        tmp = tmp_path_factory.mktemp(f"spatial{s}")
        ranks[s] = worker.launch("spatial_layers", s, str(tmp), dict(
            payload, cfg=dict(mesh_axes=["data", "spatial"],
                              mesh_shape=[1, s])))
    return one, ranks


def _err(a, b) -> float:
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("s", SLABS)
@pytest.mark.parametrize("case", CASES)
def test_layer_on_h_slabs_equals_the_whole(runs, case, s):
    one, ranks = runs
    ref = one[case]
    got = [r[case] for r in ranks[s]]
    replicated = worker.REPLICATED_OUTPUTS.get(case, ())
    for i, y in enumerate(ref["outputs"]):
        if i in replicated:
            # every peer holds the whole map, the same one
            for g in got:
                assert _err(g["outputs"][i], y) <= OUT_TOL, (case, i)
        else:
            joined = torch.cat([g["outputs"][i] for g in got], 3)
            assert joined.shape == y.shape
            assert _err(joined, y) <= OUT_TOL, (case, i, _err(joined, y))
    for i, dx in enumerate(ref["input_grads"]):
        sharded = worker.LAYER_INPUTS[case][i][1]
        parts = [g["input_grads"][i] for g in got]
        joined = torch.cat(parts, 3) if sharded else sum(parts)
        assert _err(joined, dx) <= GRAD_TOL, (case, i, _err(joined, dx))
    top = max((float(g.abs().max()) for g in ref["param_grads"].values()),
              default=0.0)
    for k, g in ref["param_grads"].items():
        for r in got:
            err = float((r["param_grads"][k] - g).abs().max())
            assert err <= PARAM_TOL * top, (case, k, err, top)


def test_a_zero_halo_would_be_caught(runs):
    """The check above sees a missing halo: the 3^3 conv of each slab on
    its own (zeros where the neighbour's rows belong), joined, errs by
    O(1) of the largest entry at the slab boundary."""
    one, _ = runs
    (x,), _ = worker.layer_data("plain_conv3")
    layer = worker._layer("plain_conv3")
    t = torch.from_numpy(x)
    alone = torch.cat([layer(p) for p in t.chunk(2, 3)], 3)
    assert _err(alone.detach(), one["plain_conv3"]["outputs"][0]) > 0.05


def test_slab_and_halo_helpers():
    """``slab`` cuts equal slabs and refuses an uneven split."""
    from cbim_tpu_torch.parallel.spatial import h_axis, slab
    x = torch.arange(2 * 3 * 8).reshape(2, 3, 8)
    np.testing.assert_array_equal(slab(x, 1, 4, 2), x[:, :, 2:4])
    assert h_axis(torch.zeros(1, 2, 3, 4, 5)) == 3
    assert h_axis(torch.zeros(1, 2, 3, 4)) == 2
    with pytest.raises(ValueError, match="equal slabs"):
        slab(x, 0, 3, 2)
