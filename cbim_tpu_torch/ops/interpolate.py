"""Linear resize with ``align_corners=True`` (counterpart of
``cbim_tpu/ops/interpolate.py``).

The reference decoder upsamples with ``F.interpolate(mode='trilinear',
align_corners=True)``; ``cbim_tpu`` re-derives that rule for XLA.  Here the
PyTorch op is the rule itself.
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
