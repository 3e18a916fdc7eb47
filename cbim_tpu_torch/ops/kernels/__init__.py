"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(``probes``: the instruments that port the JAX package's TPU probes).

Importing this package registers the model-path kernels as the
``torch.library`` custom ops ``torch.ops.cbim.*`` (``_library``), which is
all that loading an exported program needs."""

from __future__ import annotations

from . import conv2d, conv3d, fused_norm, probes, window_attention

_COUNTS = (fused_norm.launches, conv3d.launches, conv2d.launches,
           window_attention.launches, probes.launches)


def launch_counts() -> dict:
    """Launches of every kernel since the last reset, by C entry name
    (``conv3d_dgrad``/``conv2d_dgrad``: the forward kernels' input-gradient
    launches).  Under activation checkpointing the recomputed forward counts
    too."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0
