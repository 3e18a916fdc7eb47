"""Export a trained model as a self-contained serving artifact
(counterpart of the JAX package's ``tools/export_model.py``).

Freezes the inference program with ``torch.export`` (``inference/export.py``)
so that a serving host runs it with torch and ``cbim_tpu_torch.ops.kernels``
alone: no model code, config YAMLs or checkpoint files.

    python -m cbim_tpu_torch.tools.export_model --dataset amos_ct \\
        --model medformer --dimension 3d --load fold_0_best.ckpt \\
        --out medformer_amos.pt2 [--volume_shape 160,256,256] \\
        [--window_batch 1] [--batch 1] [--device cuda]

With --volume_shape the artifact is the whole sliding-window program for
that raw volume shape (pad, the window sweep, the config's fusion, crop);
without it, one window forward (+ softmax) at the training size, and the
serving host drives the sweep.  ``--load`` takes what the prediction CLI
takes (``training.checkpoint.load_weights``): the port's ``.ckpt`` (its EMA
weights when the config sets ``ema``), a ``.pth`` or a JAX run's Flax
``.ckpt``.  ``--device`` (the card unless ``cpu``) replaces the JAX CLI's
``--platform``/``--platforms``: the program is traced on that device and
runs there (a card's artifact launches the kernels).

Run the artifact:

    from cbim_tpu_torch.inference.export import load_exported
    probs = load_exported(open(path, "rb").read())(img)
"""

from __future__ import annotations

import argparse
import time


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CBIM-Torch model export")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--dimension", type=str, default="3d")
    p.add_argument("--load", type=str, required=True,
                   help="weights: the port's .ckpt, a .pth or a Flax .ckpt")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--volume_shape", type=str, default=None,
                   help="comma-separated raw volume shape; exports the whole "
                        "sliding-window program for it")
    p.add_argument("--window_batch", type=int, default=1)
    p.add_argument("--batch", type=int, default=1,
                   help="window-forward batch dim (no --volume_shape)")
    p.add_argument("--config_root", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (an sm_90 card; an error without one) or "
                        "'cpu': where the program is traced and runs")
    return p


def main(argv=None, cfg=None) -> str:
    """Run the CLI on ``argv`` (default: sys.argv); ``cfg`` replaces the
    YAML lookup with an already-built config.  Returns what it printed."""
    args = get_parser().parse_args(argv)

    from ..config import load_config
    from ..inference.export import (export_sliding_window,
                                    export_window_forward)
    from ..models import get_model
    from ..ops._backend import get_device
    from ..training.checkpoint import load_weights

    device = get_device(args.device)
    if cfg is None:
        cfg = load_config(args.dataset, args.model, args.dimension,
                          config_root=args.config_root)
    cfg.sliding_window = True
    cfg.window_size = cfg.training_size
    nd = 3 if cfg.dimension == "3d" else 2

    model = get_model(cfg, device=device)
    load_weights(args.load, model, prefer_ema=bool(cfg.get("ema", False)),
                 cfg=cfg)

    t0 = time.perf_counter()
    if args.volume_shape:
        shape = tuple(int(s) for s in args.volume_shape.split(","))
        if len(shape) != nd:
            raise ValueError(f"--volume_shape {shape} for a {nd}D model")
        data = export_sliding_window(model, cfg, shape,
                                     window_batch=args.window_batch,
                                     device=device)
        kind = f"sliding-window {shape}"
    else:
        window = tuple(cfg.window_size[:nd])
        data = export_window_forward(model, cfg, window,
                                     cfg.get("in_chan", 1), batch=args.batch,
                                     device=device)
        kind = f"window-forward {window} x{args.batch}"

    with open(args.out, "wb") as f:
        f.write(data)
    msg = (f"exported {kind} -> {args.out} ({len(data)} bytes in "
           f"{time.perf_counter() - t0:.1f} s, device={device})")
    print(msg)
    return msg


if __name__ == "__main__":
    main()
