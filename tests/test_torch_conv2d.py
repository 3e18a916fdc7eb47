"""The port's 3x3 conv kernel module vs ``cbim_tpu``'s tap-packed Pallas
conv (``cbim_tpu/ops/pallas/conv2d.py``), on the CPU.

On the CPU ``conv2d_same``, ``conv2d_dgrad``, ``conv2d_wgrad`` and the
``Conv2dSame`` Function run their plain versions (``F.conv2d`` and
``torch.nn.grad.conv2d_weight``); the CUDA kernels are held against those
plain versions on the card by ``chip_smoke.py``.  The JAX side runs the
Pallas kernels in interpret mode, as ``tests/test_pallas_conv2d.py`` does.
Every comparison is fp32 and holds the error to 1e-5 of the largest
|output|: the sums run over 9*C products (forward), 9*F (dgrad) or every
pixel (wgrad) in other orders.  Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.ops.pallas.conv2d import conv2d_same as jax_conv2d_same
from cbim_tpu.ops.pallas.conv2d import conv2d_same_t as jax_conv2d_same_t
from cbim_tpu.ops.pallas.conv2d import conv2d_wgrad as jax_conv2d_wgrad
from cbim_tpu_torch.ops.kernels import conv2d, conv3d
from test_torch_threads import few_torch_threads  # noqa: F401

#: fp32 error bound, relative to the largest |output|
REL = 1e-5


def _w_to_jax(w):
    """torch [F, C, 3, 3] -> Pallas [3, 3, C, F]."""
    return np.transpose(w, (2, 3, 1, 0))


def _close(got, ref):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= REL * scale, \
        (float(np.abs(got - ref).max()), scale)


#: (B, H, W, C, F): the Pallas kernel tiles H by 8; W any; F > 128 takes
#: its flat packing
CASES = [(1, 8, 16, 8, 8), (2, 8, 10, 8, 12), (1, 16, 24, 4, 12),
         (2, 8, 12, 32, 32), (1, 8, 20, 24, 130)]


@pytest.mark.parametrize("B,H,W,C,F", CASES)
def test_conv2d_same_matches_pallas_interpret(B, H, W, C, F):
    rng = np.random.default_rng(C * 1000 + F)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3)) / np.sqrt(9 * C)).astype(np.float32)
    y = conv2d.conv2d_same(torch.from_numpy(x), torch.from_numpy(w))
    assert y.dtype == torch.float32 and y.is_contiguous()
    ref = jax_conv2d_same(jnp.asarray(x), jnp.asarray(_w_to_jax(w)),
                          interpret=True)
    _close(y.numpy(), ref)


@pytest.mark.parametrize("C,F", [(8, 8), (8, 12), (12, 4), (16, 32)])
def test_conv2d_same_grads_match_pallas_vjp(C, F):
    """Conv2dSame's dx (forward on flip-swapped weights) and dW (wgrad) vs
    ``jax.vjp`` of ``conv2d_same_t`` (Pallas interpret: the dgrad through
    the forward kernel on ``_flip_swap2`` weights, dW through
    ``conv2d_wgrad``)."""
    rng = np.random.default_rng(C * 100 + F)
    x = rng.normal(size=(2, 8, 10, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3)) / np.sqrt(9 * C)).astype(np.float32)
    g = rng.normal(size=(2, 8, 10, F)).astype(np.float32)
    y_j, vjp = jax.vjp(jax_conv2d_same_t, jnp.asarray(x),
                       jnp.asarray(_w_to_jax(w)))
    dx_j, dw_j = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = conv2d.Conv2dSame.apply(tx, tw)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(g))
    _close(y.detach().numpy(), y_j)
    _close(tx.grad.numpy(), dx_j)
    assert tw.grad.shape == (F, C, 3, 3) and tw.grad.dtype == torch.float32
    _close(_w_to_jax(tw.grad.numpy()), dw_j)


@pytest.mark.parametrize("B,H,W,C,F", [(1, 8, 12, 4, 8), (2, 16, 9, 16, 8),
                                       (1, 8, 8, 32, 64)])
def test_conv2d_wgrad_matches_pallas_interpret(B, H, W, C, F):
    rng = np.random.default_rng(B + C + F)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    g = rng.normal(size=(B, H, W, F)).astype(np.float32)
    dw = conv2d.conv2d_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    assert dw.shape == (F, C, 3, 3) and dw.dtype == torch.float32
    ref = jax_conv2d_wgrad(jnp.asarray(x), jnp.asarray(g), interpret=True)
    _close(_w_to_jax(dw.numpy()), ref)


def test_conv2d_same_ragged_matches_lax_conv():
    """H and W that fit no TPU tile (the Pallas kernel needs H % 8 == 0; the
    CUDA kernel masks its own edges), channels that fit no vector."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, 9, 5)).astype(np.float32)
    w = (rng.normal(size=(6, 5, 3, 3)) / np.sqrt(45)).astype(np.float32)
    y = conv2d.conv2d_same(torch.from_numpy(x), torch.from_numpy(w))
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(_w_to_jax(w)), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    _close(y.numpy(), ref)


def test_conv2d_dgrad_is_the_adjoint_of_the_forward():
    """<conv(x, w), g> == <x, dgrad(g, w)> on a ragged image."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, 5, 7, 6, generator=gen, dtype=torch.float64)
    w = torch.randn(9, 6, 3, 3, generator=gen, dtype=torch.float64)
    g = torch.randn(2, 5, 7, 9, generator=gen, dtype=torch.float64)
    lhs = (conv2d.conv2d_same_plain(x.float(), w.float()).double() * g).sum()
    rhs = (x * conv2d.conv2d_dgrad(g.float(), w.float()).double()).sum()
    assert abs(float(lhs - rhs)) <= 1e-4 * float(lhs.abs())


@pytest.mark.parametrize("B,H,W,C,F", [(32, 256, 256, 32, 32),
                                       (32, 128, 128, 64, 64),
                                       (4, 64, 64, 192, 160),
                                       (3, 37, 50, 24, 40), (1, 1, 1, 4, 4)])
def test_wgrad_chunks_cover_every_pixel(B, H, W, C, F):
    """The split reduction's chunks cover the M = B*H*W pixels exactly once,
    and the fp32 partials stay within their byte cap."""
    M = B * H * W
    rows, n_chunks = conv3d.wgrad_chunking(M, C, F, taps=9)
    assert rows * n_chunks >= M > rows * (n_chunks - 1)
    assert n_chunks * 9 * C * F * 4 <= max(conv3d._WGRAD_MAX_PARTIAL_BYTES,
                                           9 * C * F * 4)


def test_conv2d_checks_its_arguments():
    x = torch.randn(1, 4, 4, 8)
    with pytest.raises(ValueError):                       # w's C
        conv2d.conv2d_same(x, torch.randn(4, 6, 3, 3))
    with pytest.raises(ValueError):                       # not 3x3
        conv2d.conv2d_same(x, torch.randn(4, 8, 5, 5))
    with pytest.raises(ValueError):                       # g's image
        conv2d.conv2d_wgrad(x, torch.randn(1, 4, 5, 8))
    with pytest.raises(ValueError):                       # dtype mismatch
        conv2d.conv2d_same(x, torch.randn(4, 8, 3, 3, dtype=torch.float64))
