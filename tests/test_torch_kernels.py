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
from cbim_tpu.ops.pallas.conv3d import conv3d_same_t as jax_conv3d_same_t
from cbim_tpu.ops.pallas.conv3d import conv3d_wgrad as jax_conv3d_wgrad
from cbim_tpu.ops.pallas.fused_norm import instance_norm_act as jax_inorm
from cbim_tpu_torch.ops import _backend
from cbim_tpu_torch.ops.kernels import (_build, conv2d, conv3d, fused_norm,
                                        launch_counts, reset_launch_counts)
from test_torch_threads import few_torch_threads  # noqa: F401


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
    """Forward and backward on the CPU run the plain versions only."""
    reset_launch_counts()
    x = torch.randn(1, 4, 4, 4, 8, requires_grad=True)
    w = torch.randn(8, 8, 3, 3, 3, requires_grad=True)
    y = conv3d.Conv3dSame.apply(x, w)
    fused_norm.instance_norm_act(y, act="relu").sum().backward()
    x2 = torch.randn(2, 5, 6, 8, requires_grad=True)
    w2 = torch.randn(4, 8, 3, 3, requires_grad=True)
    conv2d.Conv2dSame.apply(x2, w2).square().sum().backward()
    x3 = torch.randn(1, 4, 4, 4, 8, requires_grad=True)
    conv3d.ConvInormAct3d.apply(x3, w, 1e-4, "gelu").square().sum().backward()
    assert x.grad is not None and w.grad is not None
    assert x2.grad is not None and w2.grad is not None
    assert x3.grad is not None
    assert launch_counts() == {
        "inorm_stats": 0, "inorm_apply": 0, "inorm_bwd_stats": 0,
        "inorm_bwd_apply": 0, "conv3d_same_fwd": 0, "conv3d_dgrad": 0,
        "conv3d_wgrad": 0, "conv3d_same_na_fwd": 0, "conv3d_wgrad_na": 0,
        "conv3d_same_fwd_tc": 0, "conv3d_dgrad_tc": 0, "conv3d_wgrad_tc": 0,
        "conv3d_same_na_fwd_tc": 0, "conv3d_wgrad_na_tc": 0,
        "conv3d_same_fwd_tf32": 0, "conv3d_dgrad_tf32": 0,
        "conv3d_same_na_fwd_tf32": 0, "conv3d_wgrad_tf32": 0,
        "conv3d_wgrad_na_tf32": 0, "conv2d_same_fwd": 0, "conv2d_dgrad": 0, "conv2d_wgrad": 0,
        "conv2d_same_fwd_tc": 0, "conv2d_dgrad_tc": 0, "conv2d_wgrad_tc": 0,
        "conv2d_same_fwd_tf32": 0, "conv2d_dgrad_tf32": 0,
        "conv2d_wgrad_tf32": 0, "window_attention": 0, "probe_copy_scale": 0, "probe_dot_t": 0,
        "probe_gemm": 0, "conv3d_same_fwd_ladder": 0}


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
    """One nvcc per source (started together), then one link."""
    objs = _build.BUILD_DIR / "obj"
    cmds = _build.compile_commands(objs)
    assert len(cmds) == len(_build.sources())
    for cmd, src in zip(cmds, _build.sources()):
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        assert cmd[-1] == str(src)
    link = _build.link_command(_build.BUILD_DIR / "lib.so", objs)
    assert "-shared" in link
    assert sum(a.endswith(".o") for a in link) == len(cmds)
    srcs = {p.name for p in _build.sources()}
    assert {"conv2d.cu", "conv2d_tc.cu", "conv2d_wgrad_tc.cu", "conv3d.cu",
            "conv3d_tc.cu", "conv3d_wgrad_tc.cu", "conv3d_na_tc.cu",
            "conv3d_wgrad_na_tc.cu", "conv3d_tf32.cu", "conv3d_wgrad_tf32.cu",
            "conv3d_wgrad_na_tf32.cu", "conv3d_wgrad.cu",
            "conv3d_wgrad_na.cu",
            "conv2d_tf32.cu", "conv2d_wgrad_tf32.cu", "fused_norm.cu",
            "probes.cu", "window_attention.cu"} <= srcs
    assert all(_build.CSRC in p.parents for p in _build.sources())
    assert set(_build.SIGNATURES) == {
        "inorm_stats", "inorm_apply", "inorm_bwd_stats", "inorm_bwd_apply",
        "conv3d_same_fwd", "conv3d_wgrad", "conv3d_same_na_fwd",
        "conv3d_wgrad_na", "conv3d_same_fwd_tc", "conv3d_wgrad_tc",
        "conv3d_same_na_fwd_tc", "conv3d_wgrad_na_tc", "conv3d_same_fwd_tf32",
        "conv3d_same_na_fwd_tf32", "conv3d_wgrad_tf32",
        "conv3d_wgrad_na_tf32", "conv2d_same_fwd",
        "conv2d_wgrad",
        "conv2d_same_fwd_tc",
        "conv2d_wgrad_tc", "conv2d_same_fwd_tf32", "conv2d_wgrad_tf32",
        "window_attention", "probe_copy_scale",
        "probe_dot_t", "probe_gemm", "conv3d_same_fwd_ladder"}


# ---------------------------------------------------------------- backward

#: (B, D, H, W) of the backward cases: the JAX wgrad kernel tiles D by 2
#: and H by 8
BWD_SHAPE = (2, 4, 8, 10)


@pytest.mark.parametrize("C,F", [(8, 8), (8, 12), (12, 4)])
def test_conv3d_same_grads_match_pallas_vjp(C, F):
    """Conv3dSame's dx (forward on flip-swapped weights) and dW (wgrad) vs
    ``jax.vjp`` of ``conv3d_same_t`` (Pallas interpret: the dgrad through
    the forward kernel, dW through ``conv3d_wgrad``)."""
    rng = np.random.default_rng(C * 100 + F)
    x = rng.normal(size=(*BWD_SHAPE, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3, 3)) / np.sqrt(27 * C)).astype(np.float32)
    g = rng.normal(size=(*BWD_SHAPE, F)).astype(np.float32)
    y_j, vjp = jax.vjp(jax_conv3d_same_t, jnp.asarray(x),
                       jnp.asarray(_w_to_jax(w)))
    dx_j, dw_j = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = conv3d.Conv3dSame.apply(tx, tw)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(g))
    # fp32 both sides; dx sums 27*F products, dW sums 2*4*8*10 = 640
    # voxels of unit-scale products (|dW| up to ~100): 1e-5 of that scale
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_w_to_jax(tw.grad.numpy()), np.asarray(dw_j),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("C,F", [(4, 8), (16, 8)])
def test_conv3d_wgrad_plain_matches_pallas_interpret(C, F):
    rng = np.random.default_rng(C + F)
    x = rng.normal(size=(*BWD_SHAPE, C)).astype(np.float32)
    g = rng.normal(size=(*BWD_SHAPE, F)).astype(np.float32)
    dw = conv3d.conv3d_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    ref = jax_conv3d_wgrad(jnp.asarray(x), jnp.asarray(g), interpret=True)
    assert dw.shape == (F, C, 3, 3, 3) and dw.dtype == torch.float32
    # sums over 640 voxels of unit-scale products, fp32 both sides
    np.testing.assert_allclose(_w_to_jax(dw.numpy()), np.asarray(ref),
                               rtol=1e-5, atol=1e-4)


def test_conv3d_dgrad_is_the_adjoint_of_the_forward():
    """<conv(x, w), g> == <x, dgrad(g, w)> for a ragged volume."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, 3, 5, 7, 6, generator=gen, dtype=torch.float64)
    w = torch.randn(9, 6, 3, 3, 3, generator=gen, dtype=torch.float64)
    g = torch.randn(2, 3, 5, 7, 9, generator=gen, dtype=torch.float64)
    lhs = (conv3d.conv3d_same_plain(x.float(), w.float()).double() * g).sum()
    rhs = (x * conv3d.conv3d_dgrad(g.float(), w.float()).double()).sum()
    assert abs(float(lhs - rhs)) <= 1e-4 * float(lhs.abs())


@pytest.mark.parametrize("act", [None, "relu", "gelu"])
def test_instance_norm_act_grads_match_pallas_vjp(act):
    """InstanceNormAct's dx vs ``jax.vjp`` of the Pallas
    ``instance_norm_act`` (interpret), whose backward is ``_backward``."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 5, 6, 7, 24)) * 2 + 0.3).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    y_j, vjp = jax.vjp(lambda t: jax_inorm(t, eps=1e-5, act=act,
                                           interpret=True), jnp.asarray(x))
    dx_j, = vjp(jnp.asarray(dy))

    tx = torch.from_numpy(x).requires_grad_()
    y = fused_norm.instance_norm_act(tx, eps=1e-5, act=act)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(dy))
    # fp32 statistics both sides; the Pallas GELU and its derivative use an
    # erf polynomial within 1.5e-7 of erf (ROADMAP C5), torch erf itself;
    # dx is O(rstd) ~ 0.5 here
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx_j),
                               rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("act", [None, "relu", "gelu"])
def test_plain_norm_backward_matches_autograd_of_plain_forward(act):
    """The plain bwd_stats + bwd_apply formulas equal the autograd of the
    plain forward (fp64, so only the formula is tested)."""
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(2, 300, 12, generator=gen, dtype=torch.float64) * 3 + 1)
    dy = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    xr = x.clone().requires_grad_()
    mean = xr.mean(dim=1, keepdim=True)
    var = (xr - mean).square().mean(dim=1, keepdim=True)
    n = (xr - mean) * torch.rsqrt(var + 1e-5)
    y = {None: n, "relu": torch.relu(n),
         "gelu": torch.nn.functional.gelu(n)}[act]
    y.backward(dy)

    x3, dy3 = x.float(), dy.float()
    m, r = fused_norm.inorm_stats_plain(x3, 1e-5)
    red = fused_norm.inorm_bwd_stats_plain(x3, dy3, m, r, act)
    assert red.shape == (2, 2, 12) and red.dtype == torch.float32
    dx = fused_norm.inorm_bwd_apply_plain(x3, dy3, m, r, red, act)
    # fp32 evaluation of fp64-exact formulas: dx ~ O(rstd) ~ 0.3
    torch.testing.assert_close(dx, xr.grad.float(), rtol=1e-5, atol=1e-6)


def test_backward_kernel_entries_need_cuda():
    x3 = torch.randn(1, 16, 8)
    m, r = fused_norm.inorm_stats_plain(x3, 1e-5)
    with pytest.raises(ValueError):
        fused_norm.inorm_bwd_stats(x3, x3, m, r, "relu")
    with pytest.raises(ValueError):
        fused_norm.inorm_bwd_apply(x3, x3, m, r, torch.zeros(1, 2, 8), None)
    with pytest.raises(ValueError):     # g must match x's volume
        conv3d.conv3d_wgrad(torch.randn(1, 4, 4, 4, 8),
                            torch.randn(1, 4, 4, 5, 8))
