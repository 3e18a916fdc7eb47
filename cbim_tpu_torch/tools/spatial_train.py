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
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
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
                  out: str, backend: str, go) -> None:
    import torch
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      GROUP_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    # the host's cores shared out: the ranks' model builds and host work
    # would otherwise each take them all
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _warm_up(argv[argv.index("--device") + 1] != "cpu")
    go.wait()
    rank_main(cfg, argv, out, backend)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(cfg: dict, argv: list, world: int, out: str,
          backend: str = "gloo") -> tuple:
    """Spawn ``world`` ranks of :func:`rank_main` on one node (their cards
    LOCAL_RANK % count).  Each warms up (:func:`_warm_up`) and then waits
    for :func:`finish`, so a caller can start them while other work runs
    and time only their runs."""
    ctx = multiprocessing.get_context("spawn")
    go = ctx.Event()
    port = _free_port()
    # daemons: a caller that fails before finish() takes them down with it
    procs = [ctx.Process(target=_rank_process, daemon=True, args=(
        r, world, port, cfg, argv, out, backend, go)) for r in range(world)]
    for p in procs:
        p.start()
    return procs, go, out


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
