"""The port's probes: entry points that measure its kernels and the card
(``python -m cbim_tpu_torch.tools.<probe> [case ...]``, on an sm_90 card).

Counterparts of the JAX package's TPU probes in ``tools/``:
``probe_bandwidth`` (``tools/probe_bandwidth.py``), ``probe_lhst_dot``
(``tools/probe_lhst_dot.py``) and ``probe_conv_dissect``
(``tools/probe_cw_dissect.py``).  Every input is drawn from a seeded
``torch.Generator`` on the card: on zeros a wrong kernel would pass and the
tensor cores would draw less power.
"""

from __future__ import annotations

import subprocess

import torch

#: published dense peaks of one H100 SXM (fp32 on the CUDA cores, bf16 and
#: TF32 on the tensor cores) and its HBM rate (the bound of a probe's work)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, iters: int, queued: bool = False) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls (CUDA events),
    after one warm-up call.  ``queued``: the card first spins for about a
    millisecond, so the host has queued every call before the first runs
    and a call whose kernels take less time than its launch is timed on
    the card, not at the host's launch rate."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(2_000_000)        # clock cycles, about 1 ms
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of the FLOPs over the card's
    peak for ``dtype`` and the bytes (each input read once, each output
    written once) over its HBM rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` reports them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card(device: str = "cuda") -> torch.device:
    """The card a probe runs on; raises without a usable sm_90 card (a
    probe measures the card and has no CPU version to fall back to)."""
    from ..ops._backend import get_device
    dev = get_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probes measure the card: pass a CUDA device")
    return dev
