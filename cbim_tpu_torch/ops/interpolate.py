"""Linear resize with ``align_corners=True`` and nearest-neighbour resize
(counterpart of ``cbim_tpu/ops/interpolate.py``).

The reference decoder upsamples with ``F.interpolate(mode='trilinear',
align_corners=True)``; ``cbim_tpu`` re-derives that rule for XLA.  Here the
PyTorch op is the rule itself.  ``resize_nearest`` keeps the JAX package's
own index rule (floor of ``j * in / out`` in fp32, clamped), axis by axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


def resize_linear(x: torch.Tensor, out_spatial) -> torch.Tensor:
    """Resize x (B, C, *spatial) to ``out_spatial``, align_corners=True."""
    out_spatial = tuple(int(s) for s in out_spatial)
    if tuple(x.shape[2:]) == out_spatial:
        return x
    return F.interpolate(x, size=out_spatial, mode=_MODES[len(out_spatial)],
                         align_corners=True)


def resize_nearest(x: torch.Tensor, out_spatial) -> torch.Tensor:
    """Resize x (B, C, *spatial) to ``out_spatial`` by nearest neighbour:
    output index j of an axis reads input floor(j * in / out), computed in
    fp32 and clamped to the axis, as ``cbim_tpu``'s ``resize_nearest``
    (torch's 'nearest' rule); an axis already at its size is left alone."""
    for i, size in enumerate(int(s) for s in out_spatial):
        axis, n = 2 + i, x.shape[2 + i]
        if n == size:
            continue
        pos = torch.arange(size, dtype=torch.float32, device=x.device)
        idx = torch.floor(pos * n / size).long().clamp_(0, n - 1)
        x = x.index_select(axis, idx)
    return x
