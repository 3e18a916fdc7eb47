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
        from cbim_tpu_torch.parallel import initialize_distributed, make_mesh
        assert initialize_distributed(device="cpu")
        try:
            mesh = make_mesh()
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

def train_steps(mesh, payload) -> dict:
    """``payload``: the config dict, the initial state_dict and the global
    batches (numpy).  Builds the model, loads the weights, takes one
    ``make_train_step`` per batch on this rank's rows; returns the losses,
    the parameters' gradients of the first step (all-reduced: DDP's mean),
    the BatchNorm running statistics after it, and the parameters after
    every step."""
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.parallel import shard_batch
    from cbim_tpu_torch.training.train_state import (create_train_state,
                                                     make_train_step)
    cfg = config_from_dict(payload["cfg"])
    model = get_model(cfg, device="cpu", train=True)
    model.load_state_dict(payload["state_dict"])
    state = create_train_state(model, cfg, mesh=mesh)
    step = make_train_step(model, state.optimizer, cfg, mesh)
    losses, grads, buffers = [], None, None
    for img, lab in payload["batches"]:
        img, lab = shard_batch(img, mesh), shard_batch(lab, mesh)
        losses.append(float(step(state, torch.from_numpy(img),
                                 torch.from_numpy(lab).long(),
                                 cfg.base_lr)))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
            buffers = {k: b.clone() for k, b in model.named_buffers()}
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
