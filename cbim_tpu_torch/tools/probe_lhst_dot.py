"""Probe: hand-written bf16 tensor-core dots on the card, at the 3^3
conv's GEMM shape (``probe_dot_t``) and at a square calibration shape
(``probe_gemm``), both on ``wgmma`` fed by TMA (port of
``tools/probe_lhst_dot.py``: ``main`` and ``big_square``).

Operands are drawn from a seeded ``torch.Generator`` (the TPU probe timed
zeros, on which a wrong kernel passes and the tensor cores draw less
power).  Cases:

    slab        ``probe_dot_t``: out[t] = W^T A[t], W [96, 288], A [2048,
                96, 2560] -> out [2048, 288, 2560], contracting dim 0 of
                both, on wgmma m64n128k16 (W through an MN-major A
                descriptor, padded to five m64 blocks; one tile a (t,
                128 columns), one persistent block a SM, one producer
                warp and two consumer warpgroups on alternate tiles, the
                output TMA-stored from staging slots as 256-byte rows);
                every tile reloads W from L2 beside its A
                                                        (TPU: batched)
    stationary  the same, each block loading W once and keeping it in
                shared memory for all its tiles         (TPU: slabloop)
    cublas      ``torch.matmul(W.T, A)`` on the same operands
    square1k    ``probe_gemm``: 64 x [1024, 1024] . [1024, 1024] on
                wgmma m64n256k16 (a 128 x 256 tile a block, a four-stage
                TMA ring, one producer and two consumer warpgroups, one
                persistent block a SM); bound by operations, 0.139 ms
                                                       (TPU: square1k)
    mainloop1k  ``probe_gemm`` with its epilogue's stores skipped (the
                output is not written): the TMA -> wgmma mainloop alone
    cublas1k    ``torch.matmul`` on the same operands  (TPU: xla1k)

Prints ms, TFLOP/s and GB/s (each input read once, the output written
once).  At the conv's shape the dot is bound by its 4.0 GB of bytes on an
H100 (1.20 ms), not by its 290 GFLOP (0.29 ms).

Usage: python -m cbim_tpu_torch.tools.probe_lhst_dot [case ...]
"""

from __future__ import annotations

import argparse
import math

import torch

from . import card, cuda_ms

#: the TPU probe's shape: one conv's worth of tiles at (2, 128^3), each
#: 20 slabs of its 128 lanes wide
TILES, K, N, L = 2048, 96, 288, 20 * 128
#: the square calibration
SQ_TILES, SQ = 64, 1024
DOT_CASES = ("slab", "stationary", "cublas")
SQUARE_CASES = ("square1k", "mainloop1k", "cublas1k")
CASES = DOT_CASES + SQUARE_CASES


def dot_inputs(device, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """a [TILES, K, L] and w [K, N], bf16, unit-scale outputs."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(TILES, K, L, generator=gen, device=device)
    w = torch.randn(K, N, generator=gen, device=device) / math.sqrt(K)
    return a.to(torch.bfloat16), w.to(torch.bfloat16)


def square_inputs(device, seed: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(SQ_TILES, SQ, SQ, generator=gen, device=device)
    b = torch.randn(SQ, SQ, generator=gen, device=device) / math.sqrt(SQ)
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def dot_work() -> tuple[float, float]:
    """(FLOPs, bytes) of one dot at the conv's shape."""
    return (2.0 * TILES * K * N * L,
            2.0 * (TILES * K * L + K * N + TILES * N * L))


def square_work() -> tuple[float, float]:
    return (2.0 * SQ_TILES * SQ ** 3, 2.0 * (2 * SQ_TILES * SQ ** 2 + SQ ** 2))


def run(device="cuda", cases=CASES, iters: int = 10) -> dict:
    """Time each case on the card: {case: {"ms", "tflops", "gb_s"}}."""
    from ..ops.kernels import probes
    device = card(device)
    out = {}

    def timed(name, fn, work, n):
        ms = cuda_ms(fn, n)
        flops, nbytes = work
        out[name] = {"ms": ms, "tflops": flops / ms / 1e9,
                     "gb_s": nbytes / ms / 1e6}

    if set(DOT_CASES) & set(cases):
        a, w = dot_inputs(device)
        fns = {"slab": lambda: probes.dot_t(a, w, stationary=False),
               "stationary": lambda: probes.dot_t(a, w, stationary=True),
               "cublas": lambda: torch.matmul(w.t(), a)}
        for name in DOT_CASES:
            if name in cases:
                timed(name, fns[name], dot_work(), iters)
        del a, w, fns
    if set(SQUARE_CASES) & set(cases):
        a, b = square_inputs(device)
        fns = {"square1k": lambda: probes.gemm(a, b),
               "mainloop1k": lambda: probes.gemm(a, b, store=False),
               "cublas1k": lambda: torch.matmul(a, b)}
        for name in SQUARE_CASES:
            if name in cases:
                timed(name, fns[name], square_work(), 2 * iters)
    return {name: out[name] for name in cases}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("cases", nargs="*", metavar="case",
                        help=f"any of {', '.join(CASES)} (default: all)")
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args(argv)
    if set(args.cases) - set(CASES):
        parser.error(f"unknown cases {sorted(set(args.cases) - set(CASES))}")
    for name, r in run("cuda", args.cases or CASES, args.iters).items():
        print(f"{name:10s} {r['ms']:8.3f} ms  {r['tflops']:6.1f} TFLOP/s  "
              f"{r['gb_s']:7.0f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
