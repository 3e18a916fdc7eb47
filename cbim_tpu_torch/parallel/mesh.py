"""Process groups for data parallelism (counterpart of
``cbim_tpu/parallel/mesh.py``).

The JAX package runs one process per host over a device mesh whose 'data'
axis shards the batch; XLA inserts the gradient all-reduce.  The port runs
one process per GPU, launched by ``torchrun``: NCCL on the card, gloo on
the CPU (only when the caller asks for the CPU).  The names stay the JAX
package's: :func:`initialize_distributed`, :func:`make_mesh`,
:func:`shard_batch`.

The numbers are the JAX mesh's.  ``cfg.batch_size`` is the batch over all
ranks, each rank takes ``batch_size // W`` rows of it, and the loss and the
BatchNorm statistics are those of the global batch: their sums cross the
ranks through ``collectives.all_reduce_sum``, whose backward sums too.  JAX's
process is the port's node (``GROUP_RANK``), and JAX's 'data' devices of one
host are that node's ranks: validation strides volumes over nodes and shards
each volume's sweep over a node's ranks.

A second mesh axis, 'spatial' (``mesh_axes: [data, spatial]``,
``mesh_shape: [d, s]``), shards the volume's H axis over s ranks, as the
JAX mesh reshapes its devices to [d, s]: spatial peers are consecutive
ranks, rank r has data index r // s and slab r % s.  ``cfg.batch_size`` is
then split over the d data indices alone, and each of the s peers of one
data index holds the same rows, its slab of H (``parallel.spatial``).  The
world group still carries the loss's and the BatchNorm statistics' sums
and DDP's gradient mean; the spatial group carries the halos and the
statistics over space.
"""

from __future__ import annotations

import math
import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops._backend import get_device


@dataclass(frozen=True)
class Mesh:
    """This process's place in the run: the world group and this node's
    subgroup (the world group on one node), the rank and world size, the
    rank and rank count within the node, the node's index and the node
    count, and the device the collectives' tensors live on.  The host-side
    sharding (:func:`shard_batch`, the pipeline's rows and draws) reads
    only the data index and the data size.  Under a 'spatial' axis of s
    > 1 the spatial group is this rank's s peers (None otherwise), the
    spatial rank its slab of H, and the data rank and size its place on
    the 'data' axis (rank // s of W / s); without one, the data rank and
    size are the rank and the world size."""
    group: object
    node_group: object
    rank: int
    size: int
    local_rank: int
    local_size: int
    node: int
    nodes: int
    device: torch.device
    spatial_group: object = None
    spatial_rank: int = 0
    spatial_size: int = 1
    data_rank: int | None = None
    data_size: int | None = None

    def __post_init__(self):
        if self.data_rank is None:
            object.__setattr__(self, "data_rank",
                               self.rank // self.spatial_size)
        if self.data_size is None:
            object.__setattr__(self, "data_size",
                               self.size // self.spatial_size)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(cfg=None, device="cuda", group: bool = False,
                           backend: str | None = None) -> bool:
    """Start the process group of a ``torchrun`` launch (replaces
    ``jax.distributed.initialize``): reads RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE and GROUP_RANK; on CUDA sets ``cuda:LOCAL_RANK`` and
    starts an NCCL group, on the CPU a gloo group.  ``backend`` "gloo" with
    a CUDA ``device`` keeps the tensors on the card and moves them over
    gloo, whose ranks may share a card (rank r takes card r % count; NCCL
    refuses two ranks on one card).  Without WORLD_SIZE, or
    with a WORLD_SIZE of 1 and ``group`` false, it does nothing, as the JAX
    package's single-process run.  ``group`` true starts a group of one
    when the environment names none (rendezvous on a free localhost port).
    Returns whether it started a group: the caller that did tears it down
    (``dist.destroy_process_group``).  A group already up is left as it
    is."""
    if dist.is_initialized():
        return False
    world = _env_int("WORLD_SIZE", 1)
    if world == 1 and not group:
        return False
    device = get_device(device)
    kwargs = {}
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK", 0)
        backend = backend or "nccl"
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", local)
        torch.cuda.set_device(local % torch.cuda.device_count())
    elif backend not in (None, "gloo"):
        raise ValueError(f"backend {backend!r} on the CPU: only gloo")
    else:
        backend = "gloo"
    if "MASTER_ADDR" in os.environ:
        init = "env://"
    elif world == 1:
        init = f"tcp://localhost:{_free_port()}"
    else:
        raise RuntimeError("WORLD_SIZE > 1 without MASTER_ADDR: launch with "
                           "torchrun")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=_env_int("RANK", 0), **kwargs)
    return True


def _axes(cfg, world: int) -> dict:
    """The config's mesh axes and sizes, as the JAX ``make_mesh`` reshapes
    the devices: ``mesh_shape`` None puts every rank on the first axis."""
    axes = list(cfg.get("mesh_axes") or ["data"]) if cfg is not None \
        else ["data"]
    shape = cfg.get("mesh_shape") if cfg is not None else None
    if shape is None:
        shape = [world] + [1] * (len(axes) - 1)
    if len(shape) != len(axes):
        raise ValueError(f"mesh_shape {shape} does not name a size for each "
                         f"of the mesh_axes {axes}")
    return dict(zip(axes, (int(s) for s in shape)))


def make_mesh(cfg=None, device=None) -> Mesh:
    """The :class:`Mesh` of the running group (the JAX ``make_mesh``):
    checks the config's ``mesh_axes``/``mesh_shape`` against the world size,
    and builds the node subgroups (ranks ``node * LOCAL_WORLD_SIZE`` on,
    as ``torchrun`` numbers them) and, under a 'spatial' axis of s > 1,
    the spatial groups (ranks ``i * s`` to ``i * s + s - 1``).  Every rank
    makes every group, in the same order.  The collectives' tensors live
    on ``device``: by default ``cuda:LOCAL_RANK`` under NCCL and the CPU
    under gloo; a CUDA ``device`` under gloo is card LOCAL_RANK % count
    (:func:`initialize_distributed`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = _axes(cfg, world)
    spatial = (cfg.get("spatial_axis") if cfg is not None else None) \
        or "spatial"
    if "data" not in sizes:
        raise ValueError(f"mesh_axes {list(sizes)} have no 'data' axis")
    s = sizes.get(spatial, 1)
    if set(sizes) - {"data", spatial}:
        raise ValueError(f"mesh_axes {list(sizes)}: the port's mesh has the "
                         f"'data' and '{spatial}' axes only")
    if math.prod(sizes.values()) != world:
        raise ValueError(f"mesh {sizes} does not match the {world} ranks")
    if s > 1 and cfg is not None and cfg.get("training_size"):
        h = int(cfg.training_size[1 if cfg.dimension == "3d" else 0])
        if h % s:
            raise ValueError(f"training_size's H {h} does not divide over the "
                             f"'{spatial}' axis of {s}")
    local_size = _env_int("LOCAL_WORLD_SIZE", world)
    local_rank = _env_int("LOCAL_RANK", rank)
    node = _env_int("GROUP_RANK", rank // local_size)
    if world % local_size or rank != node * local_size + local_rank:
        raise ValueError(f"rank {rank} of {world} is not rank {local_rank} "
                         f"of node {node} with {local_size} ranks each")
    nodes = world // local_size
    node_group = dist.group.WORLD
    if nodes > 1:
        node_group = _subgroup(rank, local_size, nodes)
    spatial_group = _subgroup(rank, s, world // s) if s > 1 else None
    nccl = dist.get_backend() == "nccl"
    if device is None:
        device = "cuda" if nccl else "cpu"
    device = get_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank if nccl else
                              local_rank % torch.cuda.device_count())
    elif nccl:
        raise ValueError("an NCCL group needs a CUDA device")
    return Mesh(group=dist.group.WORLD, node_group=node_group, rank=rank,
                size=world, local_rank=local_rank, local_size=local_size,
                node=node, nodes=nodes, device=device,
                spatial_group=spatial_group, spatial_rank=rank % s,
                spatial_size=s)


def _subgroup(rank: int, size: int, count: int):
    """This rank's group among ``count`` groups of ``size`` consecutive
    ranks; every rank makes all of them, in the same order."""
    mine = None
    for i in range(count):
        g = dist.new_group(list(range(i * size, (i + 1) * size)))
        if i == rank // size:
            mine = g
    return mine


def batch_rows(batch_size: int, mesh: Mesh | None) -> slice:
    """This rank's rows of a global batch of ``batch_size``: the
    ``batch_size // d`` contiguous ones of its data index, as the 'data'
    axis shards axis 0 (d = W without a 'spatial' axis; the s spatial peers
    of one data index hold the same rows).  Raises unless d divides the
    batch, as JAX does."""
    if mesh is None:
        return slice(0, batch_size)
    if batch_size % mesh.data_size:
        raise ValueError(f"batch_size {batch_size} does not divide over "
                         f"{mesh.data_size} data ranks")
    b = batch_size // mesh.data_size
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def shard_batch(x, mesh: Mesh | None):
    """This rank's rows of the global batch ``x`` (axis 0)."""
    return x[batch_rows(x.shape[0], mesh)]
