"""What H-sharded training (the 'spatial' mesh axis) must not do, on the
CPU:

- gather: under s = 2 no rank holds more of H than its slab and the
  conv's halo at any conv or norm input (a dispatch mode records every
  conv's and InstanceNorm's input, forward, remat's recompute and
  backward, on the ranks and in one process, ``torch_dist_worker.
  extents_of_a_step``);
- draw apart what a sample shares: the spatial peers of a sample keep or
  drop it alike in ``DropPath``, while ``Dropout``'s elementwise masks stay
  each slab's own; the input pipeline's slabs, joined along H, are the
  data rank's augmented batch, noise included;
- take what it does not carry: an H the axis does not divide, a slab the
  model's H down-scales do not divide, a model outside the slice (named
  with its ROADMAP item).
"""

import numpy as np
import pytest
import torch

from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.factory import get_dataset
from cbim_tpu_torch.data.pipeline import TrainPipeline
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.parallel import Mesh
from cbim_tpu_torch.training.trainer import train_net
from test_torch_spatial_step import MEDFORMER, UNET, batches
from test_torch_threads import few_torch_threads  # noqa: F401
import torch_dist_worker as worker

SPATIAL = dict(mesh_axes=["data", "spatial"])


def spatial_mesh(rank: int, data: int, slabs: int) -> Mesh:
    """Rank ``rank`` of a [data, slabs] mesh on one node, without a
    process group (the pipeline and the trainer's checks read only the
    indices)."""
    size = data * slabs
    return Mesh(group=None, node_group=None, rank=rank, size=size,
                local_rank=rank, local_size=size, node=0, nodes=1,
                device=torch.device("cpu"), spatial_rank=rank % slabs,
                spatial_size=slabs)


@pytest.fixture(scope="module")
def extents(tmp_path_factory):
    """The recorded extents of one step of UNet-3D and MedFormer-3D, in
    one process and on each of two ranks."""
    runs = {}
    for name, d in (("unet", UNET), ("medformer", MEDFORMER)):
        model = get_model(config_from_dict(d), device="cpu",
                          generator=torch.Generator().manual_seed(1))
        runs[name] = dict(cfg=d, state_dict=model.state_dict(),
                          batches=batches(d)[:1])
    one = worker.extents_of_a_step(None, {"runs": runs})
    ranks = worker.launch("extents_of_a_step", 2,
                          str(tmp_path_factory.mktemp("extents")),
                          dict(runs=runs, cfg=dict(SPATIAL, mesh_shape=[1, 2])))
    return one, ranks


@pytest.mark.parametrize("model", ["unet", "medformer"])
def test_no_rank_holds_more_than_its_slab_and_halo(extents, model):
    """Op by op, the ranks' conv inputs span at most H / 2 + 2 halo rows
    of H, and all of D and W; their norm inputs half the rows.  What every
    peer holds whole takes all of it: MedFormer's semantic maps
    (``map_size``, a shape no feature level has here) and the SE blocks'
    means over space (1 x 1 x 1)."""
    one, ranks = extents
    ref = one[model]
    maps = {(1, 1, 1)}
    if model == "medformer":
        maps |= {tuple(MEDFORMER["map_size"]),
                 (int(np.prod(MEDFORMER["map_size"])),)}
    assert len(ref) > 100
    for rank in ranks:
        got = rank[model]
        assert [op for op, *_ in got] == [op for op, *_ in ref]
        for (op, ext, k), (_, whole, _) in zip(got, ref):
            if ext == whole in maps:
                continue
            if op.startswith("inorm"):
                assert 2 * ext[0] == whole[0], (op, ext, whole)
            else:
                halo = 2 * ((k - 1) // 2)
                assert ext[1] <= whole[1] // 2 + halo and \
                    (ext[0], ext[2]) == (whole[0], whole[2]), \
                    (op, ext, k, whole)


def test_spatial_peers_draw_a_sample_alike(tmp_path):
    """[2, 2]: DropPath's keeps are the same on a data index's two peers
    and differ between the data indices (seeded by the data index); the
    Dropout masks of two peers differ (seeded by the rank)."""
    x = np.ones((8, 1, 2, 4, 2), np.float32)
    draws = worker.launch("sample_draws", 4, str(tmp_path), dict(
        x=x, cfg=dict(SPATIAL, mesh_shape=[2, 2])))
    for a, b in ((0, 1), (2, 3)):
        assert torch.equal(draws[a]["drop_path"], draws[b]["drop_path"])
        assert not torch.equal(draws[a]["dropout"], draws[b]["dropout"])
    assert not torch.equal(draws[0]["drop_path"], draws[2]["drop_path"])


#: a pipeline with noise before the affine and a gated brightness after
PIPE = dict(
    dataset="synthetic", model="unet", dimension="3d", classes=3,
    training_size=[8, 16, 16], synthetic_cases=5,
    synthetic_shape=[10, 24, 24], affine_pad_size=[2, 4, 4],
    scale=[0.1, 0.2, 0.2], rotate=[10, 0, 0], translate=[0, 0, 0],
    gaussian_noise_std=0.3, k_fold=5)


def _batch(mesh, batch=4):
    cfg = config_from_dict(PIPE)
    pipe = TrainPipeline(get_dataset(cfg, mode="train"), cfg, seed=3,
                         device="cpu", mesh=mesh)
    return pipe.next_batch(batch)


@pytest.mark.parametrize("data", [1, 2])
def test_slabs_joined_are_the_data_ranks_batch(data):
    """Each data index's two slabs, joined along H, equal the batch of the
    same data index without a spatial axis ([data, 1]), the device noise
    included (seeded by the data index)."""
    for d in range(data):
        whole = _batch(spatial_mesh(d, data, 1))
        slabs = [_batch(spatial_mesh(2 * d + j, data, 2)) for j in range(2)]
        assert slabs[0][0].shape[2] == PIPE["training_size"][1] // 2
        for i in range(2):
            torch.testing.assert_close(
                torch.cat([s[i] for s in slabs], 2), whole[i], rtol=0,
                atol=0)


@pytest.mark.parametrize("keys, error, match", [
    (dict(UNET, training_size=[8, 31, 16]), ValueError, "does not divide"),
    (dict(UNET, training_size=[8, 16, 16]), ValueError,
     "H down-scales, 16"),
    (dict(UNET, model="vnet"), NotImplementedError, "ROADMAP A7b"),
    (dict(UNET, model="unet++"), NotImplementedError, "ROADMAP A7b"),
    (dict(UNET, dimension="2d", training_size=[32, 32]),
     NotImplementedError, "ROADMAP A7c"),
    (dict(UNET, model="swin_unetr"), NotImplementedError, "ROADMAP A7d"),
])
def test_train_net_refuses(tmp_path, keys, error, match):
    """Before any step or collective: an H the 'spatial' axis of 2 does not
    divide, a slab of 8 rows under UNet-3D's H down-scales (16), and the
    models of the later ROADMAP items."""
    cfg = config_from_dict(dict(keys, batch_size=2, epochs=1,
                                cp_path=str(tmp_path),
                                log_path=str(tmp_path)))
    with pytest.raises(error, match=match):
        train_net(cfg, device="cpu", mesh=spatial_mesh(0, 1, 2))


def test_initialize_distributed_takes_gloo_alone_on_the_cpu():
    """NCCL needs the card: asked for on the CPU, the group is refused
    before it starts."""
    from cbim_tpu_torch.parallel import initialize_distributed
    with pytest.raises(ValueError, match="only gloo"):
        initialize_distributed(device="cpu", group=True, backend="nccl")
