"""Probe: where ``conv3d_same_fwd``'s time goes, phase by phase (port of
``tools/probe_cw_dissect.py``).

A ladder of the production kernel cut after each phase, so the delta
between consecutive rungs is that phase's cost:

    load   the shifted input rows and weight slices read, nothing staged
    stage  + the shared-memory stores and barriers
    fma    + the register-tile FMAs
    full   + the epilogue's store: the real op, the very CUDA-core
           kernel ``conv3d_same`` launches at its tile width where its
           route is the CUDA-core one

at both tile widths the kernel has (BN = 32 and 64 output channels a block,
in place of the TPU probe's (d_blk, h_blk) sweep), beside the production
wrapper (at these widths the tensor-core kernel in bf16 and the TF32 one in
fp32, see ``conv3d.conv3d_route``) and cuDNN's ``F.conv3d`` on the same
inputs.  Shapes are the TPU
probe's, bf16 (2, 128^3, 32 -> 32) and (2, 128^3, 96 -> 32), plus fp32 at
96 -> 32.  Inputs are drawn from a seeded ``torch.Generator``.  Every rung
but ``full`` writes one value a thread and is wrong by design.

Prints ms per rung and the delta to the rung below.

Usage: python -m cbim_tpu_torch.tools.probe_conv_dissect [shape ...]
(shape: bf16_32, bf16_96, fp32_96; default all)
"""

from __future__ import annotations

import argparse
import math

import torch
import torch.nn.functional as F

from . import card, cuda_ms

#: (B, D, H, W, C, F) and dtype of each shape, by name
SHAPES = {"bf16_32": ((2, 128, 128, 128, 32, 32), "bfloat16"),
          "bf16_96": ((2, 128, 128, 128, 96, 32), "bfloat16"),
          "fp32_96": ((2, 128, 128, 128, 96, 32), "float32")}


def conv_inputs(case, dtype: str, device, seed: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, D, H, W, C] and torch weights w [F, C, 3, 3, 3], unit-scale
    outputs."""
    B, D, H, W, C, Fo = case
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, D, H, W, C, generator=gen, device=device)
    w = torch.randn(Fo, C, 3, 3, 3, generator=gen, device=device)
    dt = getattr(torch, dtype)
    return x.to(dt), (w / math.sqrt(27 * C)).to(dt)


def flops(case) -> float:
    B, D, H, W, C, Fo = case
    return 2.0 * 27 * C * Fo * B * D * H * W


def run(device="cuda", shapes=tuple(SHAPES), iters: int = 3) -> dict:
    """Time each shape's ladder on the card: {shape: {"rungs": {bn: {phase:
    ms}}, "production_ms" (``conv3d_same``), "route" (its
    ``conv3d_route``), "cudnn_ms", "production_bn"}}."""
    from ..ops.kernels import conv3d, probes
    device = card(device)
    # cuDNN's fp32 conv in full fp32, not TF32: the kernel's own precision
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in shapes:
        case, dtype = SHAPES[name]
        x, w = conv_inputs(case, dtype, device)
        rungs = {bn: {phase: cuda_ms(lambda p=phase, b=bn:
                                     probes.conv3d_same_fwd_ladder(x, w, p, b),
                                     iters)
                      for phase in probes.PHASES}
                 for bn in probes.LADDER_BN}
        xc = x.permute(0, 4, 1, 2, 3)                 # NCDHW view, no copy
        out[name] = {
            "rungs": rungs,
            "production_bn": probes.production_bn(w.shape[0]),
            "route": conv3d.conv3d_route(x.dtype, x.shape[-1], w.shape[0]),
            "production_ms": cuda_ms(lambda: conv3d.conv3d_same(x, w), iters),
            "cudnn_ms": cuda_ms(lambda: F.conv3d(xc, w, padding=1), iters)}
        del x, w, xc
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("shapes", nargs="*", metavar="shape",
                        help=f"any of {', '.join(SHAPES)} (default: all)")
    parser.add_argument("--iters", type=int, default=3)
    args = parser.parse_args(argv)
    unknown = sorted(set(args.shapes) - set(SHAPES))
    if unknown:
        parser.error(f"unknown shapes {unknown}")
    for name, r in run("cuda", args.shapes or tuple(SHAPES),
                       args.iters).items():
        case, dtype = SHAPES[name]
        print(f"{dtype} (B, D, H, W, C, F) {case}:", flush=True)
        for bn, rungs in r["rungs"].items():
            prev = 0.0
            for phase, ms in rungs.items():
                print(f"  BN={bn} {phase:5s} {ms:8.3f} ms  (+{ms - prev:7.3f})"
                      f"  {flops(case) / ms / 1e9:6.1f} TFLOP/s", flush=True)
                prev = ms
        print(f"  conv3d_same ({r['route']}) "
              f"{r['production_ms']:8.3f} ms; cuDNN F.conv3d "
              f"{r['cudnn_ms']:8.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
