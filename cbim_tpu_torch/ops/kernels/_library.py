"""The kernels as ``torch.library`` custom ops, namespace ``cbim``.

Each public kernel function is one op with three implementations:

- CUDA: picks the route and launches the kernel through ``_build.call``;
  every ``data_ptr()``, every check on real memory and the launch counter
  live there, so tracing never touches memory and a program loaded from
  an exported artifact counts its launches as the live model does;
- CPU: the plain PyTorch version the wrapper ran for a CPU tensor before
  the ops existed;
- fake: the output's shape, dtype and strides, for ``torch.export`` and
  ``torch.compile``.

An op has no implementation for any other device, so a tensor there
raises: nothing falls back.  The wrappers and the ``torch.autograd.Function``s
of the kernel modules call the ops (``torch.ops.cbim.<name>``); importing
``cbim_tpu_torch.ops.kernels`` registers all of them, which is all that
loading an exported program needs.
"""

from __future__ import annotations

import torch

NAMESPACE = "cbim"
#: the namespace's registrations, alive as long as this module
_LIB = torch.library.Library(NAMESPACE, "DEF")
#: the ops registered so far, by name (``opcheck`` runs over these)
OPS: dict = {}


def define(name: str, schema: str, cpu, cuda, fake):
    """Register ``cbim::<name>`` with ``schema`` (arguments in), ``cpu``
    as its CPU implementation, ``cuda`` as its CUDA one and ``fake`` as
    its fake implementation; return the op.

    The low-level registration (``Library.define`` and ``impl``): no
    Python layer between the dispatcher and an implementation, where
    ``torch.library.custom_op`` adds one for autograd (about 20 µs a call
    against 7 on the CPU); a backward through an op raises, as it would
    there.  The autograd Functions own the gradients."""
    _LIB.define(f"{name}{schema}")
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name).default
    OPS[name] = op
    return op


def sample_args(name: str, dtype: torch.dtype, device,
                generator: torch.Generator | None = None) -> tuple:
    """Small arguments of ``cbim::<name>`` in ``dtype`` on ``device``, on
    the route of 8-aligned widths (C = 8 -> F = 16; the window attention at
    head dim 16 with region ids): the inputs of ``torch.library.opcheck``
    in the CPU tests and on the card."""
    g = generator or torch.Generator().manual_seed(0)

    def rand(*shape, dt=dtype):
        return torch.randn(*shape, generator=g).to(device, dt)

    B, S, C, Fo = 2, (3, 4, 5), 8, 16
    stats = (rand(B, C, dt=torch.float32),
             rand(B, C, dt=torch.float32).abs() + 0.5)
    x3, dy3 = rand(B, 40, C), rand(B, 40, C)
    if name.startswith("conv2d"):
        x, g2, w = rand(B, *S[1:], C), rand(B, *S[1:], Fo), rand(Fo, C, 3, 3)
    else:
        x, g2, w = rand(B, *S, C), rand(B, *S, Fo), rand(Fo, C, 3, 3, 3)
    if name == "window_attention":
        q, k, v = (rand(4, 2, 49, 16) for _ in range(3))
        region = torch.randint(0, 3, (2, 49), generator=g,
                               dtype=torch.int32).to(device)
        return q, k, v, rand(2, 49, 49, dt=torch.float32), region
    return {
        "conv3d_same": (x, w), "conv2d_same": (x, w),
        "conv3d_dgrad": (g2, w), "conv2d_dgrad": (g2, w),
        "conv3d_wgrad": (x, g2), "conv2d_wgrad": (x, g2),
        "conv3d_same_na": (x, *stats, w, 2),
        "conv3d_wgrad_na": (x, *stats, g2, 1),
        "inorm_stats": (x3, 1e-5),
        "inorm_apply": (x3, *stats, 2),
        "inorm_bwd_stats": (x3, dy3, *stats, 1),
        "inorm_bwd_apply": (x3, dy3, *stats, rand(B, 2, C, dt=torch.float32),
                            2),
    }[name]
