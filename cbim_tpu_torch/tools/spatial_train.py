"""Train ``chip_smoke.py``'s flagship recipe on a ('data', 'spatial') mesh,
one process per rank: the H-sharded training of ``parallel.spatial`` on
the card, with each rank's launches and peak memory.

Two ways to start the ranks:

- under ``torchrun`` (one rank per card, NCCL), e.g. on four cards

      torchrun --standalone --nproc_per_node 4 \\
          -m cbim_tpu_torch.tools.spatial_train --mesh 2,2 --batch 4 \\
          --out build/spatial22

  every rank trains and writes ``rank<r>.json`` into ``--out``;
- without it, :func:`launch` (``--ranks N``, here or from ``chip_smoke.py``
  phase 6s, which starts them early with :func:`start`) spawns the N ranks
  itself with ``torchrun``'s environment, on gloo over the card's
  tensors, so that several ranks share one card (NCCL refuses two ranks
  on one card).

Each rank resets the kernels' launch counters just before
``cbim_tpu_torch.train.main`` and reads them just after, and records its
peak device memory.  Rank 0 also reads the run's per-step losses and
seconds from its ``scalars.jsonl``.  The last line of the output (rank 0
under torchrun, the launcher otherwise) is one JSON object.

:func:`start_zoo` spawns ranks of another kind, for recipes of other
models of the spatial axis (``chip_smoke.py`` phase 6s: AttentionUNet-3D,
VNet, MedFormer-2D): set up while they wait (:func:`prepare_zoo`), they
take one H-sharded step of each on a seeded batch (:func:`prepare_step`,
counters set to 0 just before each step and read just after), and then,
shared out over them, the same steps unsharded from the same seed and
batch, for the losses to hold them against.
"""

from __future__ import annotations

import argparse
import importlib
import json
import multiprocessing
import os
import socket
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the environment torchrun gives every rank
RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT")


def flagship(mesh_shape, steps: int) -> dict:
    """``chip_smoke.py``'s flagship recipe (bf16, remat, AdamW, EMA, 128^3
    crops) for ``steps`` steps on a ``mesh_shape`` [d, s] mesh."""
    sys.path.insert(0, REPO)
    smoke = importlib.import_module("chip_smoke")
    return dict(smoke.FLAGSHIP, iter_per_epoch=steps,
                mesh_axes=["data", "spatial"], mesh_shape=list(mesh_shape))


def train_argv(cfg: dict, batch: int, run: str, name: str,
               device: str = "cuda") -> list:
    """``train.main``'s flags for the recipe ``cfg`` at the global batch
    ``batch``, its outputs under ``run``: bf16 on the card, fp32 on the
    CPU."""
    return ["--dataset", cfg["dataset"], "--model", cfg["model"],
            "--dimension", cfg["dimension"], "--batch_size", str(batch),
            "--cp_path", os.path.join(run, "exp"),
            "--log_path", os.path.join(run, "log"), "--unique_name", name,
            "--folds", "1", "--device", device] + \
        (["--amp"] if device == "cuda" else [])


def prepare_step(cfg: dict, batch: int, seed: int, mesh, device):
    """One ``make_train_step`` of the recipe ``cfg``, set up: the model
    from weights drawn from ``seed``, its train state and step (DDP under
    ``mesh``), and a global batch of ``batch`` drawn from ``seed`` (images
    N(0, 1), labels uniform over the classes) on ``device``: with ``mesh``
    this rank's rows of it and, under a 'spatial' axis, its H slab of
    them; without, the whole batch.  Returns ``take()``, which takes the
    step and returns its record: the loss, the step's seconds (its first
    step, first uses included; reading the loss synchronises) and the
    set-up's, the kernels' launches in the step, and on the card the
    memory allocated before the step (``resident_bytes``) and the step's
    peak above it (``peak_bytes``: activations, gradients, optimizer
    state)."""
    import numpy as np
    import torch
    from ..config import config_from_dict
    from ..models import get_model
    from ..ops.kernels import launch_counts, reset_launch_counts
    from ..parallel import shard_batch
    from ..parallel.spatial import slab
    from ..training.train_state import create_train_state, make_train_step
    from ..training.trainer import check_spatial
    c = config_from_dict(cfg)
    if mesh is not None and mesh.spatial_size > 1:
        check_spatial(c, mesh.spatial_size)         # as the trainer does
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    shape = (batch, *c.training_size)
    img = torch.from_numpy(rng.standard_normal((*shape, 1), np.float32))
    lab = torch.from_numpy(rng.integers(0, c.classes, shape))
    if mesh is not None:
        img, lab = shard_batch(img, mesh), shard_batch(lab, mesh)
        if mesh.spatial_size > 1:
            axis = 2 if c.dimension == "3d" else 1
            img, lab = (slab(t, mesh.spatial_rank, mesh.spatial_size, axis)
                        for t in (img, lab))
    model = get_model(c, device=device, train=True,
                      generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, c, seed=seed, mesh=mesh)
    step = make_train_step(model, state.optimizer, c, mesh)
    img = img.contiguous().to(device)
    lab = lab.contiguous().to(device)
    cuda = torch.device(device).type == "cuda"
    setup = time.perf_counter() - t0

    def take() -> dict:
        resident = None
        if cuda:
            torch.cuda.synchronize(device)
            resident = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        t1 = time.perf_counter()
        loss = float(step(state, img, lab, c.base_lr))
        return {"loss": loss, "seconds": time.perf_counter() - t1,
                "setup_seconds": setup, "resident_bytes": resident,
                "peak_bytes": torch.cuda.max_memory_allocated(device)
                - resident if cuda else None,
                "launches": {k: v for k, v in launch_counts().items()
                             if v}}
    return take


def prepare_zoo(zoo: list, device: str = "cuda") -> tuple:
    """A zoo rank's steps (the environment names the rank; on the card,
    card LOCAL_RANK % count), set up (:func:`prepare_step`): each recipe
    of ``zoo`` ((name, cfg, global batch, seed)) H-sharded on a gloo group
    of the ranks (over the card's tensors), and this rank's share of the
    same steps unsharded, for the H-sharded ones to be held against (the
    i-th recipe's on rank i % W).  Returns (the sharded steps, the
    unsharded ones, the set-up's seconds), the group left up for
    :func:`zoo_main`."""
    import torch
    from ..config import config_from_dict
    from ..parallel import initialize_distributed, make_mesh
    t0 = time.perf_counter()
    initialize_distributed(device=device, backend="gloo")
    sharded = {}
    for name, cfg, batch, seed in zoo:
        mesh = make_mesh(config_from_dict(cfg), device=device)
        sharded[name] = prepare_step(cfg, batch, seed, mesh, mesh.device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    one = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device(device))
    unsharded = {name: prepare_step(cfg, batch, seed, None, one)
                 for name, cfg, batch, seed in zoo[rank::world]}
    return sharded, unsharded, time.perf_counter() - t0


def zoo_main(job: tuple, out: str) -> dict:
    """One zoo rank's steps of :func:`prepare_zoo`'s ``job``, the sharded
    ones first (in the same order on every rank), then its unsharded
    ones; ends the group, writes and returns its record."""
    import torch.distributed as dist
    sharded, unsharded, prepared = job
    t0 = time.perf_counter()
    try:
        rec = {"rank": dist.get_rank(),
               "zoo": {name: take() for name, take in sharded.items()}}
    finally:
        dist.destroy_process_group()
    rec["unsharded"] = {name: take() for name, take in unsharded.items()}
    rec.update(zoo_seconds=time.perf_counter() - t0, prepare_seconds=prepared)
    return _write(out, rec)


def rank_main(cfg: dict, argv: list, out: str, backend: str | None) -> dict:
    """One rank (the environment names it): ``train.main`` with ``argv``
    over ``backend`` (None: NCCL on the card, gloo on the CPU); writes and
    returns its record.  On the card (``--device cuda``) it takes card
    LOCAL_RANK % count and records its peak memory."""
    import torch
    from cbim_tpu_torch import train
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.ops.kernels import (_build, launch_counts,
                                            reset_launch_counts)
    rank = int(os.environ["RANK"])
    cuda = argv[argv.index("--device") + 1] != "cpu"
    if cuda:
        _build.library()
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
        torch.cuda.reset_peak_memory_stats()
    flags = argv + (["--backend", backend] if backend else [])
    reset_launch_counts()
    t0 = time.perf_counter()
    train.main(flags, cfg=config_from_dict(cfg))
    seconds = time.perf_counter() - t0
    rec = {"rank": rank, "seconds": seconds,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "launches": {k: v for k, v in launch_counts().items() if v}}
    if rank == 0:
        log = argv[argv.index("--log_path") + 1]
        name = argv[argv.index("--unique_name") + 1]
        rows = [json.loads(ln) for ln in open(os.path.join(
            log, cfg["dataset"], name, "fold_0", "scalars.jsonl"))]
        rec["losses"] = [r["value"] for r in rows
                         if r["tag"] == "Train/StepLoss"]
        rec["step_seconds"] = [r["value"] for r in rows
                               if r["tag"] == "Perf/StepSeconds"]
    return _write(out, rec)


def _write(out: str, rec: dict) -> dict:
    """``rec`` as ``out``/rank<r>.json; returns it."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"rank{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)
    return rec


def _warm_up(cuda: bool) -> None:
    """A fresh rank's one-time costs, paid before its run is timed: the
    trainer's imports, the card's context and the kernels' library, and
    one AdamW step (its first use imports much of torch.distributed)."""
    import torch
    from cbim_tpu_torch import train  # noqa: F401
    from cbim_tpu_torch.ops.kernels import _build
    device = "cpu"
    if cuda:
        _build.library()
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
        device = "cuda"
    p = torch.zeros(8, device=device, requires_grad=True)
    opt = torch.optim.AdamW([p])
    p.sum().backward()
    opt.step()


def _rank_process(rank: int, world: int, port: int, cfg: dict, argv: list,
                  out: str, backend: str, go, zoo: list | None,
                  threads: int | None) -> None:
    import torch
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      GROUP_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    # the host's cores shared out: the ranks' model builds and host work
    # would otherwise each take them all
    torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // world))
    device = argv[argv.index("--device") + 1]
    _warm_up(device != "cpu")
    job = prepare_zoo(zoo, device) if zoo is not None else None
    go.wait()
    if job is None:
        rank_main(cfg, argv, out, backend)
    else:
        zoo_main(job, out)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(cfg: dict, argv: list, world: int, out: str,
          backend: str = "gloo", zoo: list | None = None,
          threads: int | None = None) -> tuple:
    """Spawn ``world`` ranks of :func:`rank_main` on one node (their cards
    LOCAL_RANK % count), or with ``zoo`` of :func:`zoo_main` (``cfg`` and
    ``backend`` unused: ``argv`` names only the ``--device``; see
    :func:`start_zoo`), each on ``threads`` torch threads (default: the
    host's cores over ``world``).  Each warms up (:func:`_warm_up`; a zoo
    rank also sets its steps up, :func:`prepare_zoo`) and then waits for
    :func:`finish`, so a caller can start them while other work runs and
    time only their runs."""
    ctx = multiprocessing.get_context("spawn")
    go = ctx.Event()
    port = _free_port()
    # daemons: a caller that fails before finish() takes them down with it
    procs = [ctx.Process(target=_rank_process, daemon=True, args=(
        r, world, port, cfg, argv, out, backend, go, zoo, threads))
        for r in range(world)]
    for p in procs:
        p.start()
    return procs, go, out


def start_zoo(zoo: list, world: int, out: str, device: str = "cuda",
              threads: int | None = None) -> tuple:
    """:func:`start` of ``world`` ranks that take :func:`prepare_zoo`'s
    steps of the recipes ``zoo`` on ``device`` (a gloo group of their
    own)."""
    return start(None, ["--device", device], world, out, zoo=zoo,
                 threads=threads)


def release(run: tuple) -> None:
    """Let the ranks of :func:`start` train, without waiting for them."""
    run[1].set()


def finish(run: tuple, timeout: float = 600) -> list[dict]:
    """Let the ranks of :func:`start` train (if not :func:`release`d yet)
    and wait for them; their records in rank order.  Raises if a rank
    fails or outlives ``timeout``; stops every rank it started either
    way."""
    procs, go, out = run
    go.set()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise RuntimeError(f"spatial ranks ended with {codes} (None: still "
                           f"running after {timeout} s)")
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(len(procs))]


def launch(cfg: dict, argv: list, world: int, out: str,
           backend: str = "gloo", timeout: float = 600) -> list[dict]:
    """:func:`start` then :func:`finish` at once."""
    return finish(start(cfg, argv, world, out, backend), timeout)


def summary(records: list[dict], warm: int = 2) -> dict:
    """Rank 0's losses and median step seconds after ``warm`` steps, and
    every rank's peak GiB and launches."""
    steps = records[0]["step_seconds"]
    w = min(warm, len(steps) - 1)
    return {"losses": records[0]["losses"], "step_seconds": steps,
            "median_s": statistics.median(steps[w:]),
            "peak_gib": [r["peak_bytes"] / 2 ** 30 for r in records
                         if r["peak_bytes"] is not None],
            "launches": [r["launches"] for r in records]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mesh", default="1,2",
                        help="mesh_shape d,s (default 1,2)")
    parser.add_argument("--batch", type=int, default=2,
                        help="the global batch (default 2)")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--ranks", type=int, default=None,
                        help="without torchrun: spawn this many ranks on "
                             "gloo (default d * s)")
    parser.add_argument("--out", default=os.path.join(
        REPO, "build", "spatial_train"), help="the run's directory")
    args = parser.parse_args(argv)
    mesh = [int(v) for v in args.mesh.split(",")]
    cfg = flagship(mesh, args.steps)
    name = f"spatial_{mesh[0]}x{mesh[1]}"
    out = os.path.abspath(args.out)
    flags = train_argv(cfg, args.batch, out, name)
    from cbim_tpu_torch.tools import card_line
    if all(k in os.environ for k in RANK_ENV):
        if rank_main(cfg, flags, out, None)["rank"] != 0:
            return 0
        # the others' records (train.main has ended the group)
        paths = [os.path.join(out, f"rank{r}.json")
                 for r in range(int(os.environ["WORLD_SIZE"]))]
        deadline = time.monotonic() + 120
        while not all(map(os.path.exists, paths)):
            if time.monotonic() > deadline:
                raise RuntimeError(f"no record from every rank in {out}")
            time.sleep(0.5)
        records = [json.load(open(p)) for p in paths]
    else:
        records = launch(cfg, flags, args.ranks or mesh[0] * mesh[1], out)
    print(card_line(), flush=True)
    print(json.dumps(dict(mesh=mesh, batch=args.batch, **summary(records))),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
