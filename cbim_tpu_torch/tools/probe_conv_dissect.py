"""Probe: where the production 3^3 forwards spend their time, phase by
phase (port of ``tools/probe_cw_dissect.py``).

A ladder of the kernels that ``conv3d.conv3d_same`` launches on the main
path (bf16: the tensor-core kernel of ``csrc/conv3d_tc.cu``; fp32: the
unfused 3xTF32 kernel of ``csrc/conv3d_tf32.cu``), cut after each phase,
so the delta between consecutive rungs is that phase's cost:

    pack   the entry's weight-packing kernel alone (it runs before every
           rung, as in production, so the deltas above it cancel it)
    copy   + the kernel's TMA halo boxes and weight bulk copies landing,
           with the mbarrier waits and step barriers; nothing read
    frag   + the ldmatrix A and B fragments (fp32: and the TF32 hi/lo
           split of A)
    mma    + the mma.sync products (fp32: the three TF32 passes and the
           per-(kd, kh) fold into the tile's sums)
    full   + the epilogue: the production kernel itself

at the tiles (BN, MT) the production pickers choose between
(``probes.LADDER_TILES``, in place of the TPU probe's (d_blk, h_blk)
sweep), beside ``conv3d_same`` and cuDNN's ``F.conv3d`` on the same inputs.
Shapes are the TPU probe's, bf16 (2, 128^3, 32 -> 32) and (2, 128^3, 96 ->
32), plus fp32 at 96 -> 32.  Inputs are drawn from a seeded
``torch.Generator``.  Every rung but ``full`` writes one value a thread and
is wrong by design.

Prints ms per rung, the delta to the rung below and the rate of the conv's
FLOPs (fp32: of one pass), per tile.

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


def work(name: str) -> tuple[float, float, str]:
    """(FLOPs, bytes, peak) of one conv at shape ``name``, the inputs read
    once and the output written once: bf16 on the bf16 tensor cores, fp32
    as the kernel's three TF32 passes at the TF32 peak."""
    case, dtype = SHAPES[name]
    B, D, H, W, C, Fo = case
    size = 4 if dtype == "float32" else 2
    nbytes = float(size * (B * D * H * W * (C + Fo) + 27 * C * Fo))
    if dtype == "float32":
        return 3 * flops(case), nbytes, "tf32"
    return flops(case), nbytes, dtype


def tile_name(tile) -> str:
    """A ladder tile (BN, MT) as a record key, "32x4"."""
    return f"{tile[0]}x{tile[1]}"


def run(device="cuda", shapes=tuple(SHAPES), iters: int = 3) -> dict:
    """Time each shape's ladder on the card: {shape: {"rungs": {tile name:
    {phase: ms}}, "production_tile" (its name), "production_ms"
    (``conv3d_same``), "route" (its ``conv3d_route``), "cudnn_ms"}}."""
    from ..ops.kernels import conv3d, probes
    device = card(device)
    # cuDNN's fp32 conv in full fp32, not TF32: the kernel's own precision
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in shapes:
        case, dtype = SHAPES[name]
        x, w = conv_inputs(case, dtype, device)
        # queued: the packing rung alone takes less time than its launch
        rungs = {tile_name(t): {phase: cuda_ms(
                     lambda p=phase, t=t:
                     probes.conv3d_same_fwd_ladder(x, w, p, t), iters,
                     queued=True)
                     for phase in probes.PHASES}
                 for t in probes.LADDER_TILES[x.dtype]}
        xc = x.permute(0, 4, 1, 2, 3)                 # NCDHW view, no copy
        out[name] = {
            "rungs": rungs,
            "production_tile": tile_name(probes.production_tile(x.dtype,
                                                                case)),
            "route": conv3d.conv3d_route(x.dtype, x.shape[-1], w.shape[0]),
            "production_ms": cuda_ms(lambda: conv3d.conv3d_same(x, w), iters),
            "cudnn_ms": cuda_ms(lambda: F.conv3d(xc, w, padding=1), iters)}
        del x, w, xc
    return out


def rung_lines(rungs: dict, case) -> list[str]:
    """One line per rung: ms, the delta to the rung below, and the conv's
    FLOPs over the rung's time."""
    lines, prev = [], 0.0
    for phase, ms in rungs.items():
        lines.append(f"{phase:5s} {ms:8.3f} ms  (+{ms - prev:7.3f})  "
                     f"{flops(case) / ms / 1e9:6.1f} TFLOP/s")
        prev = ms
    return lines


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
        for tile, rungs in r["rungs"].items():
            prod = " (production)" if tile == r["production_tile"] else ""
            for line in rung_lines(rungs, case):
                print(f"  {tile}{prod} {line}", flush=True)
        print(f"  conv3d_same ({r['route']}) "
              f"{r['production_ms']:8.3f} ms; cuDNN F.conv3d "
              f"{r['cudnn_ms']:8.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
