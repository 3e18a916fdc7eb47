"""Time a training step (bf16, or fp32: KiTS as shipped, the ACDC 2D
recipe), or fp32 serving, of a checkout of this repository.

Runs one of ``chip_smoke.py``'s training or 3D serving phases from the
checkout at ``--root``, with that checkout's own kernels and code:

- ``--phase 5``: AMOS-CT serving (the full-width MedFormer-3D, fp32, with
  seeded weights) of the two synthetic NIfTI requests through
  ``prediction.main``;
- ``--phase 5b``: the same with ``conv_na`` on;
- ``--phase 9``: BCV SwinUNETR serving (the full-width model of
  ``configs/bcv/swin_unetr_3d.yaml``, fp32, seeded weights) of the same
  two requests: 6 window-attention launches a forward;
- ``--phase 9n``: BCV nnFormer serving (``configs/bcv/nnformer_3d.yaml``,
  fp32, seeded weights) of the same two requests: 14 launches a forward;
- ``--phase wa``: the checkout's phase-3 window-attention check at
  SwinUNETR's three stage shapes (its first three ``WA_CASES``), fp32 and
  bf16, masked and not: the kernel held against its plain version and
  timed beside SDPA;
- ``--phase 6`` (the default): the flagship recipe of ``bench.py``
  (full-width MedFormer-3D, GELU, 128^3 crops, batch 2, bf16 autocast,
  remat, AdamW, EMA, six steps on the synthetic corpus);
- ``--phase 6b``: the same recipe with ``conv_na`` on, the fused preact
  conv conv(act(IN(x))) for every BasicBlock conv;
- ``--phase 6k``: the KiTS recipe as shipped (``configs/kits/
  medformer_3d.yaml``, fp32, batch 2, host windows) on the NIfTI cases
  that ``chip_smoke.py`` writes (a checkout whose ``chip_smoke.py`` has
  ``kits_config``);
- ``--phase 6kn``: the same KiTS recipe with ``conv_na: true``, every
  kernel conv a fused preact conv (fp32: the checkout's fused forward and
  weight gradient);
- ``--phase 8``: the ACDC MedFormer-2D recipe (256^2 crops, batch 32, bf16
  autocast, six steps on ``Synthetic2D``) with ``conv2d_kernel`` on, the
  3x3 kernel route;
- ``--phase 8b``: the same recipe with ``conv2d_kernel`` off (cuDNN's 3x3
  convs, the default);
- ``--phase 8f``: the ACDC recipe in fp32 (the CLI's default, no
  ``--amp``) with ``conv2d_kernel`` on: the fp32 3x3 kernels of the
  checkout (3xTF32 at widths of multiples of 8).

It prints the step seconds, the median after the warm-up steps,
volumes/s (slices/s in 2D) and peak device memory (serving: seconds per
volume and peak device memory); with ``--profile DIR`` also the device's
busy share and kernel time by family (the trainer's profiler hook; in
serving, the requests served again under it, a volume to a step).  The
last line is one JSON object.

To compare two commits on one card, unpack the other one into a directory
that ``.gitignore`` lists and alternate the runs in one command, e.g.
``git archive <parent> | tar -x -C build/parent``, then

    python -m cbim_tpu_torch.tools.flagship_step --root build/parent
    python -m cbim_tpu_torch.tools.flagship_step
    python -m cbim_tpu_torch.tools.flagship_step
    python -m cbim_tpu_torch.tools.flagship_step --root build/parent

(each with the same ``--phase``).

Each run is its own process (its own CUDA context and kernel build) and its
own run directory, so the step times of one run never mix with another's.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=REPO,
                        help="the checkout whose chip_smoke.py and kernels run "
                             "(default: this one)")
    parser.add_argument("--phase", default="6",
                        choices=("5", "5b", "9", "9n", "wa", "6", "6b",
                                 "6k", "6kn", "8", "8b", "8f"),
                        help="5: AMOS-CT serving; 5b: the same with conv_na; "
                             "9: BCV SwinUNETR serving; 9n: BCV nnFormer "
                             "serving; wa: the window "
                             "attention at SwinUNETR's shapes; "
                             "6: the flagship 3D recipe; 6b: the same with "
                             "conv_na (the fused preact conv); 6k: the KiTS "
                             "recipe as shipped, fp32; 6kn: the same with "
                             "conv_na; 8: the ACDC "
                             "2D recipe on the 3x3 kernel route; 8b: the "
                             "same on cuDNN's 3x3 convs; 8f: the ACDC recipe "
                             "in fp32 on the 3x3 kernel route (default: 6)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="trace the steady steps into DIR")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    # the checkout's own package and script, ahead of this one's
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "cbim_tpu_torch"]:
        del sys.modules[name]
    import torch
    smoke = importlib.import_module("chip_smoke")
    from cbim_tpu_torch.ops.kernels import _build
    from cbim_tpu_torch.tools import card

    device = card("cuda")
    torch.zeros(1, device=device)                 # create the context
    _build.library()
    os.makedirs(smoke.WORK, exist_ok=True)
    name = f"step{args.phase}_{os.getpid()}_{int(time.time())}"
    if args.phase in ("5", "5b", "9", "9n"):
        return serve(smoke, device, args, root, name)
    if args.phase == "wa":
        print(f"{root} phase wa: {smoke.card_line()}", flush=True)
        record = {"errors": {}}
        smoke.phase_window_attention(device, smoke.WA_CASES[:3], record)
        print(json.dumps({"root": root, "phase": "wa", "max_abs_err":
                          record["errors"]["window_attention"]}), flush=True)
        return 0
    profile = os.path.abspath(args.profile) if args.profile else None
    kw = {}
    if args.phase in ("6k", "6kn"):
        na = dict(conv_na=True) if args.phase == "6kn" else {}
        cfg = smoke.kits_config(os.path.join(smoke.WORK, f"{name}_data"),
                                profile_dir=profile, **na)
        batch, unit = smoke.TRAIN_BATCH, "volumes"
        kw = dict(amp=False, min_steps=smoke.KITS_STEPS)
    elif args.phase in ("6", "6b"):
        cfg = dict(smoke.FLAGSHIP, conv_na=args.phase == "6b",
                   profile_dir=profile)
        batch, unit = smoke.TRAIN_BATCH, "volumes"
    else:
        cfg = dict(smoke.ACDC_TRAIN, conv2d_kernel=args.phase != "8b",
                   profile_dir=profile)
        batch, unit = smoke.TRAIN2D_BATCH, "slices"
        if args.phase == "8f":
            kw = dict(amp=False)
    tr = smoke.phase_train(device, cfg, batch, name, (), **kw)
    print(f"{root} phase {args.phase}: {smoke.card_line()}", flush=True)
    smoke.say_train(tr, unit)
    rec = {"root": root, "phase": args.phase,
           "step_seconds": tr["step_seconds"], "median_s": tr["median"],
           f"{unit}_per_s": tr["per_s"],
           "peak_gib": tr["peak_bytes"] / 2 ** 30,
           "launches": {k: v for k, v in tr["launches"].items() if v}}
    if args.profile:
        smoke.say_profile(args.profile)
        with open(os.path.join(args.profile, "summary.json")) as f:
            prof = json.load(f)
        rec.update(device_busy_share=prof["device_busy_share"],
                   kernel_ms_per_step=prof["device_kernel_seconds"]
                   / prof["steps"] * 1e3,
                   families_ms_per_step=prof["families_ms_per_step"])
    print(json.dumps(rec), flush=True)
    return 0


def serve(smoke, device, args, root: str, name: str) -> int:
    """Phase 5, 5b, 9 or 9n of the checkout's ``chip_smoke``: serve phase
    5's requests once (timed), and again under the profiler with
    ``--profile``."""
    cfg = {"9": smoke.BCV, "9n": smoke.BCV_NN}.get(args.phase) or \
        dict(smoke.AMOS, conv_na=args.phase == "5b")
    prof = os.path.abspath(args.profile) if args.profile else None
    res = smoke.phase_slice(device, cfg, smoke.REQUESTS, smoke.TARGET_SPACING,
                            name, (), prof)
    print(f"{root} phase {args.phase}: {smoke.card_line()}", flush=True)
    smoke.say_serving(res)
    rec = {"root": root, "phase": args.phase, "seconds": res["seconds"],
           "sec_per_volume": smoke.mean_seconds(res),
           "peak_gib": res["peak_bytes"] / 2 ** 30,
           "forwards": res["forwards"],
           "launches": {k: v for k, v in res["launches"].items() if v}}
    if prof:
        smoke.say_profile(prof, "volume")
        for (fn, shape, f), n in sorted(res.get("conv_shapes", {}).items()):
            print(f"    {n:5d} x {fn} {shape} -> {f}", flush=True)
        with open(os.path.join(prof, "summary.json")) as f:
            summary = json.load(f)
        rec.update(device_busy_share=summary["device_busy_share"],
                   kernel_ms_per_volume=summary["device_kernel_seconds"]
                   / summary["steps"] * 1e3,
                   families_ms_per_volume=summary["families_ms_per_step"])
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
