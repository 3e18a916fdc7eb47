"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""

from __future__ import annotations

from . import conv3d, fused_norm


def launch_counts() -> dict:
    """Launches of every kernel since the last reset, by C entry name
    (``conv3d_dgrad``: the forward kernel's input-gradient launches).  Under
    activation checkpointing the recomputed forward counts too."""
    return {**fused_norm.launches, **conv3d.launches}


def reset_launch_counts() -> None:
    for counts in (fused_norm.launches, conv3d.launches):
        for k in counts:
            counts[k] = 0
