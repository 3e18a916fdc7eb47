"""Device and kernel predicate shared by every kernel wrapper.

The kernels of this package are compiled for sm_90a, so they serve CUDA
devices of compute capability 9.0 (H100/H200).  A CPU tensor takes the
wrapper's plain PyTorch version.  A CUDA tensor on any other card, or a
tensor on any other device, raises: nothing falls back silently.
"""

from __future__ import annotations

import torch

#: the compute capability the kernels are built for (sm_90a)
KERNEL_CAPABILITY = (9, 0)


def get_device(name: str = "cuda") -> torch.device:
    """The device a run asked for; 'cuda' without a usable card raises."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda is "
                               "not available")
        check_capability(device)
    elif device.type != "cpu":
        raise RuntimeError(f"unsupported device {device}")
    return device


def check_capability(device: torch.device) -> None:
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap}; the kernels are built for sm_90a "
            f"(capability {KERNEL_CAPABILITY})")


def uses_kernels(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel.  False: run the plain version, which
    happens only for a tensor on the CPU.  Raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        check_capability(t.device)
        return True
    raise RuntimeError(f"no kernel or plain version for device {t.device}")


def check_device(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies where a kernel (an sm_90 card) or a plain
    version (the CPU) runs: the wrappers' check before they call an op,
    which would otherwise find no implementation."""
    uses_kernels(t)


def require_kernels(t: torch.Tensor) -> None:
    """The ops' CUDA implementations: raise unless ``t`` is a tensor the
    kernels take (:func:`uses_kernels`)."""
    if not uses_kernels(t):
        raise ValueError(f"kernel needs a CUDA tensor, got {t.device}")


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' dtype argument: 0 float32, 1 bfloat16."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
