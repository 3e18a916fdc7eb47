"""Multi-process checks of the port's data parallelism on the CPU: the
processes, what each runs, and the one-process runs they are held against.

The test files (``tests/test_torch_parallel_*.py``) import JAX, so a rank
is never forked from them: :func:`launch` starts W processes with the
``spawn`` method, each of which imports this module (torch and the port,
never JAX), sets torchrun's environment for its rank, runs torch on
``TEST_THREADS`` threads, starts a gloo group through
``parallel.initialize_distributed(device="cpu")`` and calls one of the
functions below with its mesh.  Each writes its result with
``torch.save``; :func:`launch` returns them in rank order, and fails with
a rank's traceback or at its own timeout.
"""

from __future__ import annotations

import multiprocessing
import os
import socket
import traceback

import numpy as np
import torch

from test_torch_threads import TEST_THREADS

#: seconds a launch of W ranks may take, start-up included
LAUNCH_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn_name: str, rank: int, world: int, local_size: int,
               port: int, out_dir: str, payload) -> None:
    out = os.path.join(out_dir, f"{fn_name}_{rank}")
    try:
        os.environ.update(
            RANK=str(rank), WORLD_SIZE=str(world),
            LOCAL_RANK=str(rank % local_size),
            LOCAL_WORLD_SIZE=str(local_size),
            GROUP_RANK=str(rank // local_size), MASTER_ADDR="localhost",
            MASTER_PORT=str(port))
        torch.set_num_threads(TEST_THREADS)
        import torch.distributed as dist
        from cbim_tpu_torch.config import config_from_dict
        from cbim_tpu_torch.parallel import initialize_distributed, make_mesh
        assert initialize_distributed(device="cpu")
        try:
            # a payload's "cfg" names the mesh (mesh_axes, mesh_shape)
            cfg = payload.get("cfg") if isinstance(payload, dict) else None
            mesh = make_mesh(config_from_dict(cfg) if cfg else None)
            result = globals()[fn_name](mesh, payload)
        finally:
            dist.destroy_process_group()
        torch.save(result, out + ".pt")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def launch(fn_name: str, world: int, out_dir: str, payload: dict,
           local_size: int | None = None,
           timeout: float = LAUNCH_TIMEOUT) -> list:
    """Run ``fn_name(mesh, payload)`` in ``world`` spawned ranks (nodes of
    ``local_size`` ranks; one node by default); their results in rank
    order."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn_name, r, world, local_size or world, port, out_dir, payload))
        for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = []
    for r in range(world):
        err = os.path.join(out_dir, f"{fn_name}_{r}.err")
        if os.path.exists(err):
            errors.append(f"rank {r}:\n" + open(err).read())
    assert not errors, "\n".join(errors)
    assert not alive, f"{fn_name}: ranks still running after {timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(os.path.join(out_dir, f"{fn_name}_{r}.pt"),
                       weights_only=False) for r in range(world)]


# -- what a rank runs (and the one-process run, with mesh None) -------------

def rank_batch(x, mesh, axis: int = 2):
    """This rank's part of a global batch (numpy, (B, D, H, W[, C]), or (B,
    H, W[, C]) with ``axis`` 1): its data index's rows, and under a
    'spatial' axis its H slab of them (H at ``axis``)."""
    from cbim_tpu_torch.parallel import shard_batch
    x = shard_batch(x, mesh)
    if mesh is not None and mesh.spatial_size > 1:
        h = x.shape[axis] // mesh.spatial_size
        x = np.take(x, range(mesh.spatial_rank * h,
                             (mesh.spatial_rank + 1) * h), axis=axis)
    return np.ascontiguousarray(x)


def _fixed_channel_masks(masks, mesh):
    """VNet's ``ChannelDropout.keep_mask`` replaced by ``masks`` (numpy
    (B, C) bools of the global batch, in call order, cycled); a rank takes
    its data index's rows of each.  Returns the original to put back."""
    from cbim_tpu_torch.models import vnet
    from cbim_tpu_torch.parallel import shard_batch
    real = vnet.ChannelDropout.keep_mask
    calls = [0]

    def keep_mask(self, x):
        m = masks[calls[0] % len(masks)]
        calls[0] += 1
        rows = torch.from_numpy(np.ascontiguousarray(shard_batch(m, mesh)))
        return rows[:, :, None, None, None].to(x.device)

    vnet.ChannelDropout.keep_mask = keep_mask
    return real


def _instance_norm_f64(x, eps, act, group=None):
    """The fused norm's function (over a channels-last x) in plain torch
    ops, any float dtype (its kernels' plain versions take fp32 and bf16
    only); with ``group``, the statistics of every H slab of the group,
    differentiable."""
    import math
    import torch.distributed as dist
    from cbim_tpu_torch.parallel.collectives import all_reduce_sum
    dims = tuple(range(1, x.dim() - 1))
    n = math.prod(x.shape[1:-1]) * (dist.get_world_size(group)
                                    if group is not None else 1)
    mean = all_reduce_sum(x.sum(dims, keepdim=True), group) / n
    d = x - mean
    var = all_reduce_sum(d.square().sum(dims, keepdim=True), group) / n
    y = d / torch.sqrt(var + eps)
    return {None: y, False: y, "relu": torch.relu(y),
            "gelu": torch.nn.functional.gelu(y)}[act]


def _in_f64():
    """Put the fp64 InstanceNorm in the place of both norm Functions of
    ``layers.convs``; returns the originals."""
    from cbim_tpu_torch.models.layers import convs
    real = convs.InstanceNormAct, convs.SpatialInstanceNormAct
    convs.InstanceNormAct = type("InstanceNormF64", (), {
        "apply": staticmethod(_instance_norm_f64)})
    convs.SpatialInstanceNormAct = convs.InstanceNormAct
    return real


def train_steps(mesh, payload, f64: bool = False) -> dict:
    """``payload``: the config dict, the initial state_dict and the global
    batches (numpy).  Builds the model, loads the weights, takes one
    ``make_train_step`` per batch on this rank's part of it
    (:func:`rank_batch`); returns the losses, the parameters' gradients of
    the first step (all-reduced: DDP's mean), the BatchNorm running
    statistics after it, and the parameters after every step.  ``f64``:
    the same in fp64 (the model and the batches; its convs on cuDNN's
    route and its InstanceNorms in plain torch ops,
    :func:`_instance_norm_f64`; the loss in fp32, as the port computes
    it)."""
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.models.layers import convs
    from cbim_tpu_torch.training.train_state import (create_train_state,
                                                     make_train_step)
    cfg = config_from_dict(payload["cfg"])
    model = get_model(cfg, device="cpu", train=True)
    model.load_state_dict(payload["state_dict"])
    if f64:
        model.double()
        for m in model.modules():
            if isinstance(m, convs.ConvNormAct):
                m.kernel = None
        real_in = _in_f64()
    state = create_train_state(model, cfg, mesh=mesh)
    step = make_train_step(model, state.optimizer, cfg, mesh)
    axis = 2 if cfg.dimension == "3d" else 1
    losses, grads, buffers = [], None, None
    masks = payload.get("channel_masks")
    if masks is not None:
        from cbim_tpu_torch.models import vnet
        real = _fixed_channel_masks(masks, mesh)
    try:
        for img, lab in payload["batches"]:
            img, lab = rank_batch(img, mesh, axis), rank_batch(lab, mesh,
                                                               axis)
            img = torch.from_numpy(img)
            losses.append(float(step(state, img.double() if f64 else img,
                                     torch.from_numpy(lab).long(),
                                     cfg.base_lr)))
            if grads is None:
                grads = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
                buffers = {k: b.clone() for k, b in model.named_buffers()}
    finally:
        if masks is not None:
            vnet.ChannelDropout.keep_mask = real
        if f64:
            convs.InstanceNormAct, convs.SpatialInstanceNormAct = real_in
    return {"losses": losses, "grads": grads, "buffers": buffers,
            "params": {k: p.detach().clone()
                       for k, p in model.named_parameters()}}


def dice_losses(mesh, payload) -> dict:
    """The Dice, cross-entropy and focal losses of this rank's rows of the
    global (logits, target): with the run's group (the global batch's) and
    without (this rank's rows alone), and the gradient of the global Dice
    loss w.r.t. this rank's logits."""
    from cbim_tpu_torch.ops import losses
    from cbim_tpu_torch.parallel import shard_batch
    logits = torch.from_numpy(shard_batch(payload["logits"], mesh))
    target = torch.from_numpy(shard_batch(payload["target"], mesh))
    logits.requires_grad_(True)
    dice = losses.dice_loss(logits, target, mesh.group)
    dice.backward()
    w = payload["weight"]
    return {"dice": float(dice), "grad": logits.grad,
            "local_dice": float(losses.dice_loss(logits, target)),
            "ce": float(losses.weighted_cross_entropy(logits, target, w,
                                                      mesh.group)),
            "focal": float(losses.focal_loss(logits, target,
                                             alpha=w, group=mesh.group))}


def _model(cfg_dict, state_dict):
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    cfg = config_from_dict(cfg_dict)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict)
    return cfg, model


def sharded_engines(mesh, payload) -> dict:
    """The engine's three sharded methods (with ``mesh``) or their
    unsharded counterparts (mesh None) on the payload's models and
    inputs."""
    from cbim_tpu_torch.inference.engines import make_engine
    out = {}
    cfg3, m3 = _model(payload["cfg3d"], payload["sd3d"])
    e3 = make_engine(m3, cfg3)
    vol = torch.from_numpy(payload["volume"])
    out["sliding_window"] = (e3.sliding_window_sharded(vol, mesh) if mesh
                             else e3.sliding_window(vol))
    cfg2, m2 = _model(payload["cfg2d"], payload["sd2d"])
    e2 = make_engine(m2, cfg2)
    slices = torch.from_numpy(payload["slices"])
    if mesh:
        out["whole_image"] = e2.whole_image_sharded(slices, mesh)
        out["sliding_window_slices"] = e2.sliding_window_slices_sharded(
            slices, mesh)
    else:
        out["whole_image"] = e2.whole_image(slices)
        out["sliding_window_slices"] = e2.sliding_window_slices(slices)
    return {k: v.clone() for k, v in out.items()}


def validate_runs(mesh, payload) -> dict:
    """``validate`` of the payload's 3D (sliding window) and 2D (whole
    image) models on their synthetic test splits, with ``mesh``."""
    from cbim_tpu_torch.data.datasets import Synthetic2D, Synthetic3D
    from cbim_tpu_torch.training.validation import validate
    out = {}
    for key, ds in (("3d", Synthetic3D), ("2d", Synthetic2D)):
        cfg, model = _model(payload[f"cfg{key}"], payload[f"sd{key}"])
        testset = ds(cfg, mode="test", k_fold=cfg.k_fold)
        out[key] = validate(model, testset, cfg, mesh=mesh)
    return out


# -- the 'spatial' mesh axis: its layers on H slabs -------------------------

class _Resize(torch.nn.Module):
    """``resize_linear`` (or ``resize_nearest``) by ``factor`` on every
    axis, as a module that ``spatial_shard`` marks (the decoders' and the
    aux head's upsample)."""

    def __init__(self, factor: int, nearest: bool = False):
        super().__init__()
        self.factor, self.nearest = factor, nearest
        self.spatial_group = None

    def forward(self, x):
        from cbim_tpu_torch.models.layers.convs import spatial_group
        from cbim_tpu_torch.ops import interpolate
        fn = interpolate.resize_nearest if self.nearest else \
            interpolate.resize_linear
        return fn(x, [n * self.factor for n in x.shape[2:]],
                  spatial_group(self))


class _Conv(torch.nn.Module):
    """A plain conv as the models call one (``layers.convs._conv``)."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        from cbim_tpu_torch.models.layers.convs import _conv
        return _conv(self.conv, x)


class _Bmha(torch.nn.Module):
    """MedFormer's B-MHA on (features, semantic map)."""

    def __init__(self):
        super().__init__()
        from cbim_tpu_torch.models.medformer import BidirectionAttention
        self.attn = BidirectionAttention(8, 8, 8, heads=2, dim_head=4)

    def forward(self, feat, smap):
        return self.attn(feat, smap)


class _UnetppUp(torch.nn.Module):
    """UNet++'s upsample of a map by its first level's scale (its ``_up``
    on a tiny UNet++'s scales and spatial group), in rank ``nd``."""

    def __init__(self, nd: int):
        super().__init__()
        from cbim_tpu_torch.models.unetpp import (UNetPlusPlus2D,
                                                  UNetPlusPlus3D)
        net = (UNetPlusPlus3D(1, 2, base_ch=1) if nd == 3 else
               UNetPlusPlus2D(1, 2, base_ch=1))
        self.scale, self.spatial_group = net.scale, None

    def forward(self, x):
        from cbim_tpu_torch.models.unetpp import UNetPlusPlus3D
        return UNetPlusPlus3D._up(self, x, 0)


def _vnet_layer(name: str) -> torch.nn.Module:
    """VNet's transitions at small widths, their dropouts off (the draws
    are ``sample_draws``'s)."""
    from cbim_tpu_torch.models import vnet
    layer = {"vnet_luconv": lambda: vnet.LUConv(4, elu=True),
             "vnet_down": lambda: vnet.DownTransition(4, 1, elu=True),
             "vnet_up": lambda: vnet.UpTransition(8, 8, 1, elu=True),
             "vnet_contbn": lambda: vnet.ContBatchNorm(4)}[name]()
    for m in layer.modules():
        if isinstance(m, vnet.ChannelDropout):
            m.p = 0.0
        if isinstance(m, vnet.ContBatchNorm):   # away from 1 and 0
            m.weight.data.uniform_(0.5, 1.5)
            m.bias.data.uniform_(-0.5, 0.5)
    return layer


def _layer(name: str) -> torch.nn.Module:
    """A layer case of ``spatial_layers``, its weights drawn from a seed."""
    from cbim_tpu_torch.models.attention_unet import (AttentionGate,
                                                      AttentionUpBlock)
    from cbim_tpu_torch.models.layers.convs import ConvNormAct, MBConv, Norm
    from cbim_tpu_torch.models.medformer import (SemanticMapGeneration,
                                                 UpBlockMF2D)
    from cbim_tpu_torch.models.unet import UpBlock2D
    torch.manual_seed(7)
    if name.startswith("vnet_"):
        return _vnet_layer(name)
    return {
        "conv3_kernel_in_gelu": lambda: ConvNormAct(
            4, 8, 3, norm="in", act="gelu", preact=True),
        "conv133_in_relu": lambda: ConvNormAct(4, 8, (1, 3, 3), norm="in",
                                               act="relu"),
        "depthwise3_in": lambda: ConvNormAct(4, 4, 3, groups=4, norm="in",
                                             act="gelu", preact=True),
        "conv_na": lambda: ConvNormAct(4, 8, 3, norm="in", act="gelu",
                                       preact=True, conv_na=True),
        "plain_conv3": lambda: _Conv(torch.nn.Conv3d(4, 8, 3, padding=1)),
        "inorm_relu": lambda: Norm("in"),
        "mbconv_se": lambda: MBConv(4, 4, 3, norm="in", act="relu"),
        "resize_x2": lambda: _Resize(2),
        "resize_x4": lambda: _Resize(4),
        "nearest_x2": lambda: _Resize(2, nearest=True),
        "map_generation": lambda: SemanticMapGeneration(4, 8, (2, 2, 2)),
        "bmha": _Bmha,
        "gate_c1": lambda: AttentionGate(4, 4, 1, nd=3),
        "attention_up3d": lambda: AttentionUpBlock(
            8, 4, 4, 1, "SingleConv", norm="in"),
        "attention_up2d": lambda: AttentionUpBlock(
            8, 4, 4, 1, "SingleConv", norm="bn", nd=2, conv2d_kernel=True),
        "unetpp_up3d": lambda: _UnetppUp(3),
        "unetpp_up2d": lambda: _UnetppUp(2),
        "unet_up2d": lambda: UpBlock2D(8, 8, 8, 1, "BasicBlock", nd=2,
                                       conv2d_kernel=True),
        "up_mf2d": lambda: UpBlockMF2D(
            8, 8, 8, 1, 1, map_in_dim=8, heads=2, dim_head=4,
            conv2d_kernel=True),
        "conv2d_kernel_bn": lambda: ConvNormAct(4, 8, 3, norm="bn",
                                                act="relu", nd=2,
                                                conv2d_kernel=True),
    }[name]()


#: each layer case's inputs: (shape, sharded along H) per input; the
#: outputs of a case are sharded where its first input is, but for the
#: semantic maps (replicated: every peer holds them whole)
LAYER_INPUTS = {
    "conv3_kernel_in_gelu": [((2, 4, 4, 8, 6), True)],
    "conv133_in_relu": [((2, 4, 4, 8, 6), True)],
    "depthwise3_in": [((2, 4, 4, 8, 6), True)],
    "conv_na": [((2, 4, 4, 8, 6), True)],
    "plain_conv3": [((2, 4, 4, 8, 6), True)],
    "inorm_relu": [((2, 4, 4, 8, 6), True)],
    "mbconv_se": [((2, 4, 4, 8, 6), True)],
    "resize_x2": [((2, 3, 3, 4, 5), True)],
    "resize_x4": [((2, 3, 3, 4, 5), True)],
    "nearest_x2": [((2, 3, 3, 4, 5), True)],
    "map_generation": [((2, 4, 4, 8, 6), True)],
    "bmha": [((2, 8, 4, 8, 6), True), ((2, 8, 2, 2, 2), False)],
}
#: the layers of the models of ROADMAP A7b and A7c, as ``LAYER_INPUTS``:
#: VNet's 5^3 conv (a halo of 2 planes: 2 rows a slab at s = 4), its
#: strided down and transposed up transitions and ContBatchNorm;
#: AttentionUNet's gate at C = 1 and its up blocks (3D InstanceNorm, 2D
#: BatchNorm on the 3x3 kernel route); UNet++'s upsample; the 2D UNet's
#: and MedFormer-2D's up blocks (the latter with a B-MHA block and its
#: semantic map, which every peer holds whole); a 2D 3x3 ConvNormAct on
#: the kernel route with BatchNorm
ZOO_LAYER_INPUTS = {
    "vnet_luconv": [((2, 4, 4, 8, 6), True)],
    "vnet_down": [((2, 4, 4, 16, 4), True)],
    "vnet_up": [((2, 8, 2, 4, 2), True), ((2, 4, 4, 8, 4), True)],
    "vnet_contbn": [((2, 4, 4, 8, 6), True)],
    "gate_c1": [((2, 4, 4, 8, 6), True), ((2, 4, 4, 8, 6), True)],
    "attention_up3d": [((2, 8, 2, 4, 3), True), ((2, 4, 4, 8, 6), True)],
    "attention_up2d": [((2, 8, 4, 6), True), ((2, 4, 8, 12), True)],
    "unetpp_up3d": [((2, 3, 3, 4, 5), True)],
    "unetpp_up2d": [((2, 3, 4, 5), True)],
    "unet_up2d": [((2, 8, 4, 6), True), ((2, 8, 8, 12), True)],
    "up_mf2d": [((2, 8, 4, 6), True), ((2, 8, 8, 12), True),
                ((2, 8, 2, 2), False)],
    "conv2d_kernel_bn": [((2, 4, 8, 6), True)],
}
#: the outputs every peer holds whole, by case
REPLICATED_OUTPUTS = {"map_generation": (0,), "bmha": (1,), "up_mf2d": (1,)}


def layer_inputs(name: str) -> list:
    """A case's inputs: (shape, sharded along H) each."""
    return (LAYER_INPUTS[name] if name in LAYER_INPUTS else
            ZOO_LAYER_INPUTS[name])


def layer_data(name: str) -> tuple[list, list]:
    """(inputs, upstream gradients of the outputs), drawn with numpy; the
    gradients' shapes come from a forward of the unsharded layer."""
    rng = np.random.RandomState(3)
    xs = [rng.randn(*shape).astype(np.float32)
          for shape, _ in layer_inputs(name)]
    outs = _outputs(_layer(name), [torch.from_numpy(x) for x in xs], name)
    gys = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    return xs, gys


def _outputs(module, xs, name):
    if name == "inorm_relu":
        out = module(xs[0], "relu")
    else:
        out = module(*xs)
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _h_slab(x, mesh):
    """This rank's slab of x (B, C, *spatial) along H, the second-to-last
    axis."""
    from cbim_tpu_torch.parallel.spatial import h_axis, slab
    return slab(x, mesh.spatial_rank, mesh.spatial_size, h_axis(x))


def spatial_layers(mesh, payload) -> dict:
    """Every case of ``payload["cases"]`` (with its ``layer_data``) on this
    rank's H slab (``mesh``), or whole (mesh None): the outputs (this
    rank's slab, or the whole of a replicated one), the inputs' gradients
    from sum(output * upstream) (a replicated output's upstream counted on
    the group's first rank only, as the one-process loss counts it once)
    and the parameters' gradients summed over the group.  The layer's
    BatchNorms take the world group's statistics, as the train state marks
    them (``sync_batch_norm``)."""
    import torch.distributed as dist
    from cbim_tpu_torch.models.layers.convs import (CHANNELS_LAST,
                                                    spatial_shard,
                                                    sync_batch_norm)
    out = {}
    for name in payload["cases"]:
        xs, gys = payload["data"][name]
        module = _layer(name)
        inputs = []
        for x, (_, sharded) in zip(xs, layer_inputs(name)):
            t = torch.from_numpy(x)
            if mesh is not None and sharded:
                t = _h_slab(t, mesh)
            inputs.append(t.contiguous(
                memory_format=CHANNELS_LAST[t.dim() - 2]).requires_grad_(True))
        if mesh is not None:
            sync_batch_norm(module, mesh.group)
            spatial_shard(module, mesh.spatial_group)
        ys = _outputs(module, inputs, name)
        loss = 0.0
        for i, (y, gy) in enumerate(zip(ys, gys)):
            gy = torch.from_numpy(gy)
            if mesh is not None:
                if i in REPLICATED_OUTPUTS.get(name, ()):
                    gy = gy * (mesh.spatial_rank == 0)
                else:
                    gy = _h_slab(gy, mesh)
            loss = loss + (y * gy).sum()
        loss.backward()
        grads = {k: p.grad.clone() for k, p in module.named_parameters()}
        if mesh is not None:
            for g in grads.values():
                dist.all_reduce(g, group=mesh.spatial_group)
        out[name] = {"outputs": [y.detach().clone() for y in ys],
                     "input_grads": [t.grad.clone() for t in inputs],
                     "param_grads": grads}
    return out


def train_steps_many(mesh, payload) -> dict:
    """:func:`train_steps` of each of ``payload["runs"]`` (name -> its
    payload) in turn, on one group; for the names in
    ``payload["f64"]`` also the fp64 steps, under ``name + ":f64"``."""
    out = {}
    for name, run in payload["runs"].items():
        out[name] = train_steps(mesh, run)
        if name in payload.get("f64", ()):
            out[name + ":f64"] = train_steps(mesh, run, f64=True)
    return out


#: the conv and norm ops whose inputs' extents ``extents_of_a_step``
#: records: (the argument whose extent counts, its first spatial axis,
#: None for the norms' flattened rows; the weight argument of cuDNN's
#: convs, None for the 3^3 kernels)
RECORDED_OPS = {
    "convolution": (0, 2, 1), "convolution_backward": (1, 2, 2),
    "conv3d_same": (0, 1, None), "conv3d_dgrad": (0, 1, None),
    "conv3d_wgrad": (0, 1, None), "conv3d_same_na": (0, 1, None),
    "conv3d_wgrad_na": (0, 1, None), "inorm_stats": (0, None, None),
    "inorm_apply": (0, None, None), "inorm_bwd_stats": (0, None, None),
    "inorm_bwd_apply": (0, None, None),
}


def extents_of_a_step(mesh, payload) -> dict:
    """One ``train_steps`` step per model of ``payload["runs"]`` under a
    dispatch mode that records, in order, every conv and norm op's input
    extent: (op, its (D, H, W) and the kernel's rows of H for a conv; op,
    its flattened rows (S,) and 1 for a norm), forward, remat's recompute
    and backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._overloadpacket.__name__
            if name in RECORDED_OPS:
                i, axis, w = RECORDED_OPS[name]
                if axis is None:
                    self.seen.append((name, (args[i].shape[1],), 1))
                else:
                    k = 3 if w is None else args[w].shape[3]
                    self.seen.append(
                        (name, tuple(args[i].shape[axis:axis + 3]), k))
            return func(*args, **(kwargs or {}))

    out = {}
    for name, run in payload["runs"].items():
        with Recorder() as rec:
            train_steps(mesh, run)
        out[name] = rec.seen
    return out


def sample_draws(mesh, payload) -> dict:
    """A ``DropPath``, a ``Dropout`` and VNet's ``ChannelDropout``, each of
    rate 0.5, through ``create_train_state``'s generators, on this rank's
    part of ``payload["x"]`` (all ones, (B, C, D, H, W)): each sample's
    DropPath keep (True where the sample survives), the Dropout's keep
    mask and the ChannelDropout's keep of each (sample, channel), and
    whether the channel dropout kept or dropped each of them whole on the
    slab."""
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models.layers.convs import Dropout, DropPath
    from cbim_tpu_torch.models.vnet import ChannelDropout
    from cbim_tpu_torch.training.train_state import create_train_state
    model = torch.nn.Sequential(DropPath(0.5), Dropout(0.5),
                                ChannelDropout(0.5))
    model.register_parameter("w", torch.nn.Parameter(torch.ones(1)))
    create_train_state(model, config_from_dict(dict(
        optimizer="sgd", base_lr=0.1)), seed=3, mesh=mesh)
    x = torch.from_numpy(rank_batch(payload["x"], mesh))
    kept = model[0](x)
    channels = model[2](torch.ones_like(x)).ne(0).flatten(2)
    return {"drop_path": kept.flatten(1).ne(0).all(1),
            "dropout": model[1](torch.ones_like(x)).ne(0),
            "channel_dropout": channels.all(2),
            "channels_whole": bool((channels.all(2)
                                    | ~channels.any(2)).all())}


def spatial_layers_zoo(mesh, payload) -> dict:
    """:func:`spatial_layers` of the cases, and (on ranks) the refusal of a
    VNet whose deepest slab is thinner than its 5^3 convs' halo of 2: the
    message of each rank's error, or None."""
    out = spatial_layers(mesh, payload)
    if mesh is None:
        return out
    from cbim_tpu_torch.models import vnet
    from cbim_tpu_torch.models.layers.convs import spatial_shard
    torch.manual_seed(7)
    net = vnet.VNet(1, 2, base_ch=2).train()
    for m in net.modules():
        if isinstance(m, vnet.ChannelDropout):
            m.p = 0.0
    spatial_shard(net, mesh.spatial_group)
    x = torch.zeros(payload["thin_vnet_input"])
    try:
        net(_h_slab(x, mesh))
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out
