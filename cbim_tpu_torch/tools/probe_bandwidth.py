"""Probe: the HBM rate an elementwise bf16 pass reaches on the card, by
access width and block size (port of ``tools/probe_bandwidth.py``).

Every case computes y = 2 x on one 256 MiB bf16 buffer of 2 x 128^3 x 32
values, drawn from a seeded ``torch.Generator``:

    torch32   ``x * 2`` on the (B, S, 32) view           (TPU probe: xla32)
    torch128  ``x * 2`` on the (B, S/4, 128) view        (xla128)
    scalar2k  ``probe_copy_scale``, 2-byte accesses, 2048 elements a block
              (pl32: the lane-sparse view)
    vec2k     16-byte accesses, 2048 a block             (pl128: lane-dense)
    vec8k     16-byte accesses, 8192 a block             (plbig)
    scalar8k  2-byte accesses, 8192 a block
    conv32    ``conv3d_same`` -> copy-scale (vec2k) on its NDHWC output
              viewed [S, 32] -> ``conv3d_same``          (conv32)
    conv128   the same through the [S/4, 128] view       (conv128)

The TPU probe asked whether a conv's output reaches a 128-lane view without
a relayout copy; here both views share the output's memory (asserted), so
the two conv cases should take the same time.

Prints ms per pass and GB/s of the copy's bytes (read + write once; the
conv cases count the copy's bytes only, as the TPU probe did).

Usage: python -m cbim_tpu_torch.tools.probe_bandwidth [case ...]
"""

from __future__ import annotations

import argparse
import math

import torch

from . import card, cuda_ms

B, S, C = 2, 128 ** 3, 32
#: (vec, block) of each kernel case
KERNEL_CASES = {"scalar2k": (False, 2048), "vec2k": (True, 2048),
                "vec8k": (True, 8192), "scalar8k": (False, 8192)}
CASES = ("torch32", "torch128", *KERNEL_CASES, "conv32", "conv128")
#: the conv cases' volume: 2 x 128^3 x 32 -> 32
CONV_SHAPE = (B, 128, 128, 128, C)


def nbytes() -> int:
    """Bytes a pass reads and writes (bf16 in and out)."""
    return B * S * C * 2 * 2


def make_input(device, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(B, S, C, generator=gen,
                       device=device).to(torch.bfloat16)


def conv_inputs(device, seed: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(*CONV_SHAPE, generator=gen, device=device)
    w = torch.randn(C, C, 3, 3, 3, generator=gen, device=device)
    return (x.to(torch.bfloat16),
            (w / math.sqrt(27 * C)).to(torch.bfloat16))


def conv_sandwich(x: torch.Tensor, w: torch.Tensor, width: int
                  ) -> torch.Tensor:
    """conv -> copy-scale of its output viewed [S', width] -> conv."""
    from ..ops.kernels import conv3d, probes
    h = conv3d.conv3d_same(x, w)
    view = h.view(-1, width)
    assert view.data_ptr() == h.data_ptr(), "the view copied"
    return conv3d.conv3d_same(probes.copy_scale(view).view(h.shape), w)


def run(device="cuda", cases=CASES, iters: int = 20) -> dict:
    """Time each case on the card: {case: {"ms", "gb_s"}}."""
    from ..ops.kernels import probes
    device = card(device)
    x = make_input(device)
    x128 = x.view(B, S // 4, 128)
    conv = conv_inputs(device) if {"conv32", "conv128"} & set(cases) else None
    fns = {"torch32": lambda: x * 2, "torch128": lambda: x128 * 2,
           "conv32": lambda: conv_sandwich(*conv, 32),
           "conv128": lambda: conv_sandwich(*conv, 128)}
    for name, (vec, block) in KERNEL_CASES.items():
        fns[name] = (lambda v=vec, b=block:
                     probes.copy_scale(x, vec=v, block=b))
    out = {}
    for name in cases:
        n = max(3, iters // 4) if name.startswith("conv") else iters
        ms = cuda_ms(fns[name], n)
        out[name] = {"ms": ms, "gb_s": nbytes() / ms / 1e6}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("cases", nargs="*", metavar="case",
                        help=f"any of {', '.join(CASES)} (default: all)")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if set(args.cases) - set(CASES):
        parser.error(f"unknown cases {sorted(set(args.cases) - set(CASES))}")
    for name, r in run("cuda", args.cases or CASES, args.iters).items():
        print(f"{name:9s} {r['ms']:8.3f} ms  {r['gb_s']:7.0f} GB/s",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
