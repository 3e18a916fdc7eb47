"""The port's config defaults against ``cbim_tpu``'s (the ``block`` default
of ROADMAP C18 and the mesh keys), ``parallel.mesh``, and the input
pipeline's rows under data parallelism, on the CPU in one process.

- C18: a 3D UNet-family config without ``block`` builds ConvNormAct in
  both packages: the JAX model's params map onto the port's model
  (``state_dict_from_jax``, strict) and the eval forwards agree; the two
  ``YAML_DEFAULTS`` differ only in the keys each package keeps alone.
- The mesh: ``initialize_distributed`` does nothing without a launch,
  ``make_mesh`` checks ``mesh_axes``/``mesh_shape`` against the world size
  (a one-rank gloo group here: a 'spatial' axis of 2 does not fit it), and
  ``shard_batch`` gives each rank its rows.
- The pipeline: two ranks' batches (``local_mesh``: the rows and draws of a
  rank need no process group), concatenated, are the one-process batch
  with the noise ops off, from the 3D device cache and from 2D host
  windows; with noise on, the ranks' noise streams differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cbim_tpu import config as jax_config_module
from cbim_tpu.config import config_from_dict as jax_config
from cbim_tpu.models import get_model as jax_get_model
from cbim_tpu_torch import config as config_module
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.data.factory import get_dataset
from cbim_tpu_torch.data.pipeline import TrainPipeline
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers.convs import ConvNormAct
from cbim_tpu_torch.parallel import (Mesh, initialize_distributed,
                                     make_mesh, shard_batch)
from cbim_tpu_torch.utils.jax_import import state_dict_from_jax
from test_torch_swin_unetr import jax_params
from test_torch_threads import few_torch_threads  # noqa: F401

#: the keys one package's ``YAML_DEFAULTS`` has and the other's lacks: the
#: JAX runtime's (augmentation device, loader workers, torch.compile) and
#: the port's kernel-route options
OWN_KEYS = {"aug_device", "num_workers", "torch_compile", "conv_na",
            "conv2d_kernel"}
#: a tiny 3D UNet-family config without ``block``
NO_BLOCK = dict(dataset="synthetic", dimension="3d", classes=3, in_chan=1,
                base_chan=4, norm="in", down_scale=[[2, 2, 2]] * 4,
                kernel_size=[[3, 3, 3]] * 5, training_size=[16, 32, 32])
PROB_ATOL = 1e-4
#: the environment ``torchrun`` gives every process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT")


def local_mesh(rank: int, size: int) -> Mesh:
    """Rank ``rank`` of ``size`` on one node, without a process group."""
    return Mesh(group=None, node_group=None, rank=rank, size=size,
                local_rank=rank, local_size=size, node=0, nodes=1,
                device=torch.device("cpu"))


def test_yaml_defaults_equal_jax_but_each_packages_own_keys():
    port, ref = config_module.YAML_DEFAULTS, jax_config_module.YAML_DEFAULTS
    assert set(port) ^ set(ref) == OWN_KEYS
    assert {k: port[k] for k in port if k in ref} == \
        {k: ref[k] for k in ref if k in port}
    assert port["block"] == "ConvNormAct"
    assert port["mesh_axes"] == ["data"] and port["mesh_shape"] is None


@pytest.mark.parametrize("model", ["unet", "resunet", "unet++",
                                   "attention_unet"])
def test_config_without_block_builds_the_jax_model(model):
    """No ``block`` key: both packages build ConvNormAct blocks; the JAX
    model's params load strictly into the port's and the eval softmaxes
    agree."""
    d = dict(NO_BLOCK, model=model)
    assert "block" not in d
    jc, cfg = jax_config(d), config_from_dict(d)
    assert jc.block == cfg.block == "ConvNormAct"
    jm = jax_get_model(jc)
    x = np.random.default_rng(0).normal(size=(1, 16, 32, 32, 1)).astype(
        np.float32)
    params = jax_params(jm, x.shape, seed=1)
    net = get_model(cfg, device="cpu")
    net.load_state_dict(state_dict_from_jax(cfg, {"params": params}))
    assert any(isinstance(m, ConvNormAct) for m in net.modules())
    ref = jax.nn.softmax(jm.apply({"params": params}, jnp.asarray(x)), -1)
    with torch.inference_mode():
        out = net(torch.from_numpy(x).movedim(-1, 1))
    out = out[0] if isinstance(out, (list, tuple)) else out
    np.testing.assert_allclose(torch.softmax(out, 1).movedim(1, -1).numpy(),
                               np.asarray(ref), rtol=0, atol=PROB_ATOL)


@pytest.fixture
def no_launch(monkeypatch):
    """No torchrun environment, no process group."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()


@pytest.mark.parametrize("world", [None, "1"])
def test_initialize_distributed_without_a_launch_does_nothing(
        no_launch, monkeypatch, world):
    """No WORLD_SIZE, or a WORLD_SIZE of 1 and no group asked for: no
    group, as the JAX package's single-process run."""
    if world is not None:
        monkeypatch.setenv("WORLD_SIZE", world)
    assert initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


@pytest.fixture
def one_rank(no_launch):
    """A one-rank gloo group, asked for."""
    assert initialize_distributed(device="cpu", group=True)
    yield
    dist.destroy_process_group()


def test_make_mesh_of_one_rank(one_rank):
    mesh = make_mesh(config_from_dict({}))
    assert (mesh.rank, mesh.size, mesh.node, mesh.nodes) == (0, 1, 0, 1)
    assert mesh.device.type == "cpu"
    assert mesh.node_group is mesh.group


@pytest.mark.parametrize("keys, error", [
    (dict(mesh_shape=[2]), ValueError),                 # 'data' != ranks
    (dict(mesh_axes=["data"], mesh_shape=[1, 1]), ValueError),
    (dict(mesh_axes=["model"]), ValueError),            # no 'data' axis
    (dict(mesh_axes=["data", "spatial"], mesh_shape=[1, 2]),
     ValueError),                                      # 2 ranks != 1
    (dict(mesh_axes=["data", "h"], mesh_shape=[1, 2], spatial_axis="h"),
     ValueError),
])
def test_make_mesh_refuses(one_rank, keys, error):
    with pytest.raises(error):
        make_mesh(config_from_dict(keys))


def test_shard_batch_gives_each_rank_its_rows():
    x = np.arange(12).reshape(6, 2)
    rows = [shard_batch(x, local_mesh(r, 3)) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate(rows), x)
    np.testing.assert_array_equal(rows[1], x[2:4])
    np.testing.assert_array_equal(shard_batch(x, None), x)
    with pytest.raises(ValueError):
        shard_batch(x, local_mesh(0, 4))


#: the pipelines' configs: Synthetic3D on the device cache (gaussian noise
#: before the affine, a gated brightness after) and Synthetic2D from host
#: windows (the per-epoch permutation; noise before the affine)
PIPE3D = dict(
    dataset="synthetic", model="unet", dimension="3d", classes=3,
    training_size=[8, 16, 16], synthetic_cases=5,
    synthetic_shape=[10, 24, 24], affine_pad_size=[2, 4, 4],
    scale=[0.1, 0.2, 0.2], rotate=[10, 0, 0], translate=[0, 0, 0],
    gaussian_noise_std=0.0, k_fold=5)
PIPE2D = dict(
    dataset="synthetic", model="unet", dimension="2d", classes=3,
    training_size=[16, 16], synthetic_cases=3, affine_pad_size=[4, 4],
    scale=[0.1, 0.1], rotate=20, translate=[0.05, 0.05],
    gaussian_noise_std=0.0, device_cache=False, k_fold=3)
BATCH, STEPS = 4, 3


def _batches(d, mesh, steps=STEPS):
    cfg = config_from_dict(d)
    pipe = TrainPipeline(get_dataset(cfg, mode="train"), cfg, seed=3,
                         device="cpu", mesh=mesh)
    return pipe, [pipe.next_batch(BATCH) for _ in range(steps)]


@pytest.mark.parametrize("d", [PIPE3D, PIPE2D], ids=["3d_cache", "2d_host"])
def test_ranks_batches_concatenated_are_the_one_process_batch(d):
    pipe, one = _batches(d, None)
    assert (pipe.cache_img is not None) == (d["dimension"] == "3d")
    ranks = [_batches(d, local_mesh(r, 2))[1] for r in range(2)]
    for step, (img, lab) in enumerate(one):
        assert ranks[0][step][0].shape[0] == BATCH // 2
        torch.testing.assert_close(
            torch.cat([r[step][0] for r in ranks]), img, rtol=0, atol=0)
        torch.testing.assert_close(
            torch.cat([r[step][1] for r in ranks]), lab, rtol=0, atol=0)


def test_ranks_draw_their_own_noise():
    """The noise is drawn on the device from a generator seeded seed +
    rank: with an identity affine the noise a rank adds (its noisy batch
    less its clean one) differs between the ranks, where a shared seed
    would add the same."""
    flat = dict(PIPE2D, scale=[0.0, 0.0], rotate=0, translate=[0.0, 0.0])
    noise = []
    for r in range(2):
        pipe, noisy = _batches(dict(flat, gaussian_noise_std=0.5),
                               local_mesh(r, 2), steps=1)
        assert pipe._gen_dev.initial_seed() == 3 + r
        _, clean = _batches(flat, local_mesh(r, 2), steps=1)
        noise.append(noisy[0][0] - clean[0][0])
    assert all(float(n.abs().mean()) > 0.1 for n in noise)
    assert float((noise[0] - noise[1]).abs().mean()) > 0.1


def test_train_net_refuses_a_batch_the_ranks_do_not_divide(tmp_path):
    """A global batch of 4 over 3 ranks raises before any step, as the JAX
    mesh refuses an uneven 'data' shard."""
    from cbim_tpu_torch.training.trainer import train_net
    cfg = config_from_dict(dict(PIPE3D, batch_size=4, epochs=1,
                                cp_path=str(tmp_path), log_path=str(tmp_path)))
    with pytest.raises(ValueError, match="does not divide"):
        train_net(cfg, device="cpu", mesh=local_mesh(0, 3))
