"""The port's window-attention kernel module vs ``cbim_tpu``'s Pallas kernel,
on the CPU.

On the CPU ``window_attention`` runs its plain version (the CUDA kernel is
held against that plain version on the card by ``chip_smoke.py`` phase 3).
The JAX side runs ``fused_window_attention`` in interpret mode and
``reference_window_attention``, as ``tests/test_pallas.py`` does, with the
port's two bias parts (relative-position bias and region ids) pre-broadcast
to the dense (B, H, N, N) bias the TPU kernel reads.  Inputs come from numpy
with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.models.swin_layers import compute_attn_mask as jax_attn_mask
from cbim_tpu.ops.pallas.window_attention import (fused_window_attention,
                                                  reference_window_attention)
from cbim_tpu_torch.models.swin_layers import (compute_attn_mask,
                                               compute_region_ids)
from cbim_tpu_torch.ops.kernels import (launch_counts, reset_launch_counts,
                                        window_attention as wa)
from test_torch_threads import few_torch_threads  # noqa: F401

#: tolerances of tests/test_pallas.py: fp32 sums in another order; bf16
#: inputs, fp32 math, one rounding of the output
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, H, N, D, nW, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, N, D)).astype(np.float32)
               for _ in range(3))
    rel_bias = rng.normal(size=(H, N, N)).astype(np.float32)
    region = rng.integers(0, 4, size=(nW, N)).astype(np.int32)
    return q, k, v, rel_bias, region


def _dense_bias(rel_bias, region, B):
    """The TPU kernel's (B, H, N, N) bias: rel_bias plus the -100 mask of
    window b % nW (window_partition is batch-major)."""
    nW = region.shape[0]
    mask = np.where(region[:, :, None] != region[:, None, :], -100.0, 0.0)
    bias = rel_bias[None] + mask[np.arange(B) % nW][:, None]
    return bias.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,N,D", [(4, 3, 64, 32), (2, 6, 343, 16),
                                     (4, 2, 49, 16)])
def test_plain_matches_pallas_interpret_and_reference(B, H, N, D, dtype):
    q, k, v, rel_bias, region = _inputs(B, H, N, D, nW=2, seed=N)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    out = wa.window_attention(tq, tk, tv, torch.from_numpy(rel_bias),
                              torch.from_numpy(region))
    assert out.dtype == tq.dtype and out.shape == (B, H, N, D)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    bias = jnp.asarray(_dense_bias(rel_bias, region, B))
    for ref in (fused_window_attention(jq, jk, jv, bias, interpret=True),
                reference_window_attention(jq, jk, jv, bias)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_without_region_matches_the_shared_bias_kernel():
    """No shift: the (1, H, N, N) bias form of the TPU kernel."""
    q, k, v, rel_bias, _ = _inputs(3, 4, 64, 16, nW=1, seed=5)
    out = wa.window_attention(*map(torch.from_numpy, (q, k, v, rel_bias)))
    ref = fused_window_attention(*map(jnp.asarray, (q, k, v)),
                                 jnp.asarray(rel_bias[None]), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("spatial,window,shift", [
    ((14, 14, 14), (7, 7, 7), (3, 3, 3)),
    ((8, 12, 12), (4, 6, 6), (2, 3, 3)),
    ((4, 14, 14), (4, 7, 7), (0, 3, 3)),     # one axis unshifted
    ((21, 21, 21), (7, 7, 7), (3, 3, 3)),
    ((14, 14, 14), (7, 7, 7), (0, 0, 0)),    # unshifted: no mask
])
def test_region_ids_give_compute_attn_mask(spatial, window, shift):
    ref = jax_attn_mask(spatial, window, shift)
    ids = compute_region_ids(spatial, window, shift)
    if ref is None:
        assert ids is None
        assert compute_attn_mask(spatial, window, shift) is None
        return
    assert ids.dtype == np.int32 and ids.shape == ref.shape[:2]
    np.testing.assert_array_equal(
        wa.region_mask(torch.from_numpy(ids)).numpy(), ref)
    np.testing.assert_array_equal(compute_attn_mask(spatial, window, shift),
                                  ref)


def test_cpu_calls_do_not_launch():
    reset_launch_counts()
    q, k, v, rel_bias, region = _inputs(2, 2, 49, 16, nW=2, seed=1)
    wa.window_attention(*map(torch.from_numpy, (q, k, v, rel_bias, region)))
    assert launch_counts()["window_attention"] == 0


def test_wrapper_checks_its_inputs():
    q = torch.randn(2, 3, 49, 16)
    bias = torch.randn(3, 49, 49)
    with pytest.raises(ValueError):                  # k of another shape
        wa.window_attention(q, q[:, :2], q, bias)
    with pytest.raises(ValueError):                  # bias of another N
        wa.window_attention(q, q, q, bias[:, :48, :48])
    with pytest.raises(ValueError):                  # nW does not divide B
        wa.window_attention(q, q, q, bias,
                            torch.zeros(3, 49, dtype=torch.int32))
    with pytest.raises(ValueError):                  # region ids not int32
        wa.window_attention(q, q, q, bias, torch.zeros(2, 49))
    with pytest.raises(TypeError):
        wa.window_attention(q.double(), q.double(), q.double(), bias)


def test_no_silent_fallback_for_other_devices():
    """Only CPU tensors take the plain version; a meta tensor raises."""
    q = torch.empty(2, 3, 49, 16, device="meta")
    with pytest.raises(RuntimeError):
        wa.window_attention(q, q, q, torch.empty(3, 49, 49, device="meta"))


def test_kernel_path_raises_rather_than_fall_back(monkeypatch):
    """Where the wrapper would launch the kernel (``uses_kernels`` is
    patched true, so this runs without a card) it raises when autograd
    would need a gradient (there is no backward kernel) and for head dims
    the kernel is not built for; it never runs the plain version instead."""
    monkeypatch.setattr(wa._backend, "uses_kernels", lambda t: True)
    monkeypatch.setattr(wa, "window_attention_plain", None)
    bias = torch.randn(3, 49, 49)
    q = torch.randn(2, 3, 49, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        wa.window_attention(q, q, q, bias)
    with torch.no_grad(), pytest.raises(ValueError, match="head dims"):
        q8 = torch.randn(2, 3, 49, 8)
        wa.window_attention(q8, q8, q8, bias)
