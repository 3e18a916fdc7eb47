"""The port's kernel modules vs ``cbim_tpu``'s Pallas kernels, on the CPU.

On the CPU each wrapper of ``cbim_tpu_torch.ops.kernels`` runs its plain
PyTorch version (the CUDA kernels are checked against those plain versions
on the card by ``chip_smoke.py``).  The JAX side runs the Pallas kernels in
interpret mode, as the JAX package's own tests do.  Inputs come from numpy
with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.ops.pallas.conv3d import conv3d_same as jax_conv3d_same
from cbim_tpu.ops.pallas.fused_norm import instance_norm_act as jax_inorm
from cbim_tpu_torch.ops import _backend
from cbim_tpu_torch.ops.kernels import (_build, conv3d, fused_norm,
                                        launch_counts, reset_launch_counts)


def _w_to_jax(w):
    """torch [F, C, 3, 3, 3] -> Flax/Pallas [3, 3, 3, C, F]."""
    return np.transpose(w, (2, 3, 4, 1, 0))


@pytest.mark.parametrize("C,F", [(8, 8), (24, 16)])
def test_conv3d_same_matches_pallas_interpret(C, F):
    rng = np.random.default_rng(C)
    x = rng.normal(size=(1, 4, 8, 8, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3, 3)) / np.sqrt(27 * C)).astype(np.float32)
    y = conv3d.conv3d_same(torch.from_numpy(x), torch.from_numpy(w))
    ref = jax_conv3d_same(jnp.asarray(x), jnp.asarray(_w_to_jax(w)),
                          interpret=True)
    # fp32 both sides; K = 27*C products summed in another order
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_conv3d_same_ragged_matches_lax_conv():
    """D/H/W that fit no TPU tile, channel counts that fit no vector."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 7, 9, 12)).astype(np.float32)
    w = (rng.normal(size=(20, 12, 3, 3, 3)) / np.sqrt(27 * 12)).astype(np.float32)
    y = conv3d.conv3d_same(torch.from_numpy(x), torch.from_numpy(w))
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(_w_to_jax(w)), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-4, 1e-5])
@pytest.mark.parametrize("act", [None, "relu", "gelu"])
def test_instance_norm_act_matches_pallas_interpret(act, eps, dtype):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 5, 6, 7, 32)) * 2 + 0.3).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y = fused_norm.instance_norm_act(tx, eps=eps, act=act)
    ref = jax_inorm(jx, eps=eps, act=act, interpret=True)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    if dtype == "float32":
        # fp32 statistics both sides; the Pallas GELU's erf is a polynomial
        # within 1.5e-7 of erf, torch's is erf itself
        rtol, atol = 1e-5, 1e-5
    else:
        # both compute in fp32 and round once to bf16: where the fp32 values
        # straddle a rounding boundary they differ by one bf16 ulp (2^-7
        # relative at most)
        rtol, atol = 2 ** -7, 1e-6
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


def test_cpu_calls_leave_launch_counters_at_zero():
    reset_launch_counts()
    x = torch.randn(1, 4, 4, 4, 8)
    conv3d.conv3d_same(x, torch.randn(8, 8, 3, 3, 3))
    fused_norm.instance_norm_act(x, act="relu")
    assert launch_counts() == {"inorm_stats": 0, "inorm_apply": 0,
                               "conv3d_same_fwd": 0}


def test_plain_stats_and_apply_compose_to_instance_norm_act():
    x = torch.randn(2, 6, 5, 4, 12) * 3 + 1
    x3 = x.reshape(2, -1, 12)
    mean, rstd = fused_norm.inorm_stats_plain(x3, 1e-5)
    assert mean.shape == rstd.shape == (2, 12) and mean.dtype == torch.float32
    y = fused_norm.inorm_apply_plain(x3, mean, rstd, "gelu").reshape(x.shape)
    torch.testing.assert_close(
        y, fused_norm.instance_norm_act(x, eps=1e-5, act="gelu"))
    ref = torch.nn.functional.gelu(torch.nn.functional.instance_norm(
        x.movedim(-1, 1), eps=1e-5)).movedim(1, -1)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)


def test_wrappers_check_their_inputs():
    x = torch.randn(1, 4, 4, 4, 8)
    with pytest.raises(ValueError):
        conv3d.conv3d_same(x, torch.randn(8, 6, 3, 3, 3))     # C mismatch
    with pytest.raises(ValueError):
        conv3d.conv3d_same(x, torch.randn(8, 8, 3, 3, 3).bfloat16())
    with pytest.raises(TypeError):
        conv3d.conv3d_same(x.double(), torch.randn(8, 8, 3, 3, 3).double())
    with pytest.raises(ValueError):
        fused_norm.instance_norm_act(x, act="swish")
    with pytest.raises(TypeError):
        fused_norm.instance_norm_act(x.half())
    with pytest.raises(ValueError):      # the kernel entry needs CUDA
        fused_norm.inorm_stats(x.reshape(1, -1, 8), 1e-5)


def test_no_silent_fallback_for_other_devices():
    """Only CPU tensors take the plain versions; anything else raises."""
    meta = torch.empty(1, 4, 4, 4, 8, device="meta")
    assert _backend.uses_kernels(torch.empty(1)) is False
    with pytest.raises(RuntimeError):
        _backend.uses_kernels(meta)
    with pytest.raises(RuntimeError):
        fused_norm.instance_norm_act(meta)
    with pytest.raises(RuntimeError):
        conv3d.conv3d_same(meta, torch.empty(8, 8, 3, 3, 3, device="meta"))


def test_build_command_targets_sm90a_from_repo_sources():
    cmd = _build.build_command(_build.BUILD_DIR / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    srcs = {p.name for p in _build.sources()}
    assert {"conv3d.cu", "fused_norm.cu"} <= srcs
    assert all(_build.CSRC in p.parents for p in _build.sources())
    assert set(_build.SIGNATURES) == {"inorm_stats", "inorm_apply",
                                      "conv3d_same_fwd"}
