"""The fused preact conv, conv(act(InstanceNorm(x))), of the port vs
``cbim_tpu``'s, on the CPU.

The JAX side runs ``_cw_stats``, ``conv3d_same_cw_na``,
``conv3d_wgrad_cw2_na`` and the custom VJP ``conv_inorm_act_cw_t`` in
interpret mode, as ``tests/test_pallas_conv.py`` does, in the NDHCW layout
they take (D % 2 == 0, H % 8 == 0).  On the CPU the port's wrappers run their
plain versions.  Inputs come from numpy with a seed, with a clearly nonzero
mean, so that a padding normalised to act(-mean * rstd) instead of 0 fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.ops.pallas.conv3d import (_cw_stats, conv3d_same_cw_na,
                                        conv3d_wgrad_cw2_na,
                                        conv_inorm_act_cw_t, from_cw, to_cw)
from cbim_tpu_torch.models.layers import convs
from cbim_tpu_torch.models.layers.convs import ConvNormAct
from cbim_tpu_torch.ops.kernels import conv3d, fused_norm

#: (B, D, H, W, C, F): the JAX kernels tile D by 2 and H by 8
SHAPE = (2, 4, 8, 16, 8, 8)
EPS = 1e-4
ACTS = [None, "relu", "gelu"]


def _inputs(seed, shape=SHAPE):
    B, D, H, W, C, F = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=1.5, size=(B, D, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3, 3)) / np.sqrt(27 * C)).astype(np.float32)
    g = rng.normal(size=(B, D, H, W, F)).astype(np.float32)
    return x, w, g


def _w_to_jax(w):
    """torch [F, C, 3, 3, 3] -> Pallas [3, 3, 3, C, F]."""
    return np.transpose(w, (2, 3, 4, 1, 0))


def _stats(x):
    """(mean, rstd) float32 [B, C] in fp64, and the JAX stat [B, 2, C, 1]."""
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(1, 2, 3))
    rstd = 1.0 / np.sqrt(x64.var(axis=(1, 2, 3)) + EPS)
    mean, rstd = mean.astype(np.float32), rstd.astype(np.float32)
    return mean, rstd, jnp.asarray(np.stack([mean, rstd], axis=1)[..., None])


def test_plain_stats_match_cw_stats():
    """(a) ``inorm_stats_plain`` (two-pass) vs ``_cw_stats`` (one-pass sums
    of x and x^2 in fp32) over 512 voxels of mean 1.5, unit variance."""
    x, _, _ = _inputs(0)
    B, C = x.shape[0], x.shape[-1]
    mean, rstd = fused_norm.inorm_stats_plain(
        torch.from_numpy(x).reshape(B, -1, C), EPS)
    stat = np.asarray(_cw_stats(to_cw(jnp.asarray(x)), EPS, interpret=True))
    assert stat.shape == (B, 2, C, 1)
    np.testing.assert_allclose(mean.numpy(), stat[:, 0, :, 0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), stat[:, 1, :, 0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_conv3d_same_na_matches_pallas_interpret(act):
    """(b) the same statistics into both; fp32, 27*C products summed in
    another order, and the Pallas GELU's erf polynomial within 1.5e-7 of
    erf."""
    x, w, _ = _inputs(1)
    mean, rstd, stat = _stats(x)
    y = conv3d.conv3d_same_na(torch.from_numpy(x), torch.from_numpy(mean),
                              torch.from_numpy(rstd), torch.from_numpy(w), act)
    ref = from_cw(conv3d_same_cw_na(to_cw(jnp.asarray(x)), stat,
                                    jnp.asarray(_w_to_jax(w)), act,
                                    interpret=True))
    assert y.shape == ref.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    # the padding is zero after the norm: the unfused chain with F.conv3d's
    # zero padding of the normalised tensor agrees, a raw-zero padding not
    xn = conv3d._normed(torch.from_numpy(x), torch.from_numpy(mean),
                        torch.from_numpy(rstd), act)
    torch.testing.assert_close(y, conv3d.conv3d_same_plain(
        xn, torch.from_numpy(w)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_conv3d_wgrad_na_matches_pallas_interpret(act):
    """(c) dW in torch's [F, C, 3, 3, 3] against the Pallas [3, 3, 3, C, F]:
    fp32 sums over 2*4*8*16 = 1024 voxels, held to 2e-4 of max|dW|."""
    x, _, g = _inputs(2)
    mean, rstd, stat = _stats(x)
    dw = conv3d.conv3d_wgrad_na(torch.from_numpy(x), torch.from_numpy(mean),
                                torch.from_numpy(rstd), torch.from_numpy(g),
                                act)
    ref = np.asarray(conv3d_wgrad_cw2_na(to_cw(jnp.asarray(x)), stat,
                                         to_cw(jnp.asarray(g)), act,
                                         interpret=True))
    assert dw.shape == (SHAPE[5], SHAPE[4], 3, 3, 3)
    assert dw.dtype == torch.float32
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(_w_to_jax(dw.numpy()), ref, rtol=0,
                               atol=2e-4 * scale)


@pytest.mark.parametrize("act", ACTS)
def test_conv_inorm_act_grads_match_pallas_vjp(act):
    """(d) ``ConvInormAct3d`` forward, dx and dW vs ``jax.vjp`` of
    ``conv_inorm_act_cw_t`` (interpret): dgrad of the normalised input, the
    na wgrad, and the InstanceNorm backward; the JAX test's 2e-4."""
    x, w, g = _inputs(3)
    y_j, vjp = jax.vjp(lambda a, b: conv_inorm_act_cw_t(a, b, EPS, act),
                       to_cw(jnp.asarray(x)), jnp.asarray(_w_to_jax(w)))
    dx_j, dw_j = vjp(to_cw(jnp.asarray(g)))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = conv3d.ConvInormAct3d.apply(tx, tw, EPS, act)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(from_cw(y_j)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(from_cw(dx_j)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_w_to_jax(tw.grad.numpy()), np.asarray(dw_j),
                               rtol=2e-4, atol=2e-4)


def test_conv_inorm_act_computes_only_the_gradients_asked_for():
    x, w, g = _inputs(4)
    tx = torch.from_numpy(x)
    tw = torch.from_numpy(w).requires_grad_()
    conv3d.ConvInormAct3d.apply(tx, tw, EPS, "relu").backward(
        torch.from_numpy(g))
    assert tx.grad is None and tw.grad is not None
    tx.requires_grad_()
    y = conv3d.ConvInormAct3d.apply(tx, tw.detach(), EPS, "relu")
    dx, = torch.autograd.grad(y, tx, torch.from_numpy(g))
    assert dx.shape == tx.shape


@pytest.mark.parametrize("act", ACTS)
def test_conv_na_convnormact_equals_the_unfused_route(act):
    """(e) on the CPU the fused route computes the unfused chain's values
    with the same parameters: forward, input and weight gradients."""
    torch.manual_seed(0)
    fused = ConvNormAct(8, 12, 3, norm="in", act=act, preact=True,
                        conv_na=True)
    plain = ConvNormAct(8, 12, 3, norm="in", act=act, preact=True)
    assert fused.state_dict().keys() == plain.state_dict().keys()
    plain.load_state_dict(fused.state_dict())
    assert fused.fused and not plain.fused
    rng = np.random.default_rng(5)
    x = torch.from_numpy(
        rng.normal(loc=1.5, size=(2, 8, 4, 6, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 12, 4, 6, 5)).astype(np.float32))
    grads = []
    for m in (fused, plain):
        xi = x.clone().requires_grad_()
        y = m(xi)
        y.backward(g)
        grads.append((y.detach(), xi.grad, m.conv.weight.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


#: (ConvNormAct kwargs, whether conv_na fuses it)
GATE = [
    (dict(in_ch=8, out_ch=8, norm="in", act="gelu", preact=True), True),
    (dict(in_ch=192, out_ch=64, norm="in", act="relu", preact=True), True),
    (dict(in_ch=8, out_ch=128, norm="in", act=None, preact=True), True),
    (dict(in_ch=8, out_ch=8, norm="in", act="gelu", preact=False), False),
    (dict(in_ch=8, out_ch=8, norm="bn", act="relu", preact=True), False),
    (dict(in_ch=8, out_ch=8, norm=False, act=False, preact=True), False),
    (dict(in_ch=8, out_ch=8, norm="in", act="relu", preact=True,
          groups=8), False),
    (dict(in_ch=8, out_ch=8, norm="in", act="relu", preact=True,
          kernel_size=1), False),
    (dict(in_ch=8, out_ch=8, norm="in", act="relu", preact=True, nd=2),
     False),
    (dict(in_ch=8, out_ch=8, norm="in", act="leakyrelu", preact=True),
     False),
    (dict(in_ch=200, out_ch=8, norm="in", act="relu", preact=True), False),
    (dict(in_ch=8, out_ch=160, norm="in", act="relu", preact=True), False),
]


@pytest.mark.parametrize("kw,fuses", GATE)
def test_conv_na_route_is_taken_exactly_where_the_gate_says(kw, fuses,
                                                            monkeypatch):
    """(f) preact, InstanceNorm, 3^3 ungrouped 3D conv inside the kernel's
    channel envelope, an act the norm kernels fuse: the forward goes through
    ``ConvInormAct3d``, and only there; without ``conv_na`` never."""
    calls = []

    class Counting:
        @staticmethod
        def apply(*args):
            calls.append(1)
            return conv3d.ConvInormAct3d.apply(*args)

    monkeypatch.setattr(convs, "ConvInormAct3d", Counting)
    kw = dict(kw)
    in_ch, out_ch = kw.pop("in_ch"), kw.pop("out_ch")
    nd = kw.get("nd", 3)
    x = torch.randn(1, in_ch, *(4,) * nd)
    for conv_na in (True, False):
        calls.clear()
        m = ConvNormAct(in_ch, out_ch, conv_na=conv_na, **kw)
        assert m.fused == (fuses and conv_na)
        if kw["act"] != "leakyrelu":      # not ported: no forward to run
            m(x)
            assert len(calls) == int(fuses and conv_na)
