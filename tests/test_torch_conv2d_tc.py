"""The tensor-core route of the port's 3x3 conv, on the CPU.

``conv2d_route`` decides before any launch which kernel family a CUDA call
takes; the tensor-core forward reads the weights in the layout of
``pack_weights_tc2d`` (the dgrad's flip-swap applied by the same packing)
and the tensor-core wgrad splits its pixel tiles by
``wgrad_tc2d_chunking``.  The kernels themselves run only on the card
(``chip_smoke.py`` phase 3 holds them against their plain versions); here
the route, the launches the wrappers make, the packing, the chunking and
the bf16 plain versions are held against the JAX package's Pallas kernels
and VJP in interpret mode.  Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.ops.pallas.conv2d import conv2d_same as jax_conv2d_same
from cbim_tpu.ops.pallas.conv2d import conv2d_same_t as jax_conv2d_same_t
from cbim_tpu.ops.pallas.conv2d import conv2d_wgrad as jax_conv2d_wgrad
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers.convs import ConvNormAct
from cbim_tpu_torch.ops.kernels import conv2d
from cbim_tpu_torch.ops.kernels.conv3d import _WGRAD_MAX_PARTIAL_BYTES
from test_torch_threads import few_torch_threads  # noqa: F401

#: (B, H, W) of the Pallas cases: its kernels tile H by 8
SHAPE = (2, 8, 20)
#: a narrow width and the ragged one of chip_smoke.py's 3x3 cases
WIDTHS = [(16, 8), (24, 40)]
#: bf16 outputs of fp32 sums rounded once on both sides: where the sums
#: straddle a rounding boundary they differ by one bf16 ulp, at most 2^-8
#: of max|ref|; a wrong tap, flip or channel errs by O(max|ref|)
BF16_TOL = 2 ** -7
#: dW in fp32 from bf16 inputs (exact products) summed over 320 pixels in
#: other orders
WGRAD_TOL = 1e-5

#: the model keys of configs/acdc/medformer_2d.yaml, on the 3x3 kernel
#: route
ACDC = dict(
    dataset="acdc", model="medformer", dimension="2d", classes=4, in_chan=1,
    base_chan=32, conv_block="BasicBlock", map_size=3,
    conv_num=[2, 0, 0, 0, 0, 0, 2, 2], trans_num=[0, 2, 2, 2, 2, 2, 0, 0],
    num_heads=[1, 4, 8, 16, 8, 4, 1, 1], expansion=2, fusion_depth=2,
    fusion_dim=512, fusion_heads=16, attn_drop=0.0, proj_drop=0.0,
    proj_type="depthwise", aux_loss=True, training_size=[256, 256],
    conv2d_kernel=True)


def _w_to_jax(w):
    """torch [F, C, 3, 3] -> Pallas [3, 3, C, F]."""
    return np.transpose(w, (2, 3, 1, 0))


def _bf16_inputs(C, F, seed):
    """x, w, g as bf16 torch tensors and the same values as bf16 jax
    arrays (w in the Pallas layout)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(*SHAPE, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(F, C, 3, 3))
                          / np.sqrt(9 * C)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(*SHAPE, F)).astype(np.float32))
    t = [v.bfloat16() for v in (x, w, g)]
    j = [jnp.asarray(v, jnp.bfloat16) for v in
         (t[0].float().numpy(), _w_to_jax(t[1].float().numpy()),
          t[2].float().numpy())]
    return t, j


def _f32(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


def _close(got, ref, tol):
    ref = _f32(ref)
    err = np.abs(_f32(got) - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


# ------------------------------------------------------------------ route

@pytest.mark.parametrize("dtype,C,F,route", [
    (torch.bfloat16, 32, 32, conv2d.TENSOR_CORE),
    (torch.bfloat16, 64, 64, conv2d.TENSOR_CORE),
    (torch.bfloat16, 192, 160, conv2d.TENSOR_CORE),
    (torch.bfloat16, 24, 40, conv2d.TENSOR_CORE),
    (torch.bfloat16, 8, 8, conv2d.TENSOR_CORE),
    (torch.float32, 32, 32, conv2d.TF32X3),
    (torch.float32, 64, 64, conv2d.TF32X3),
    (torch.bfloat16, 20, 36, conv2d.CUDA_CORE),
    (torch.bfloat16, 12, 32, conv2d.CUDA_CORE),
    (torch.bfloat16, 32, 4, conv2d.CUDA_CORE),
    (torch.bfloat16, 1, 32, conv2d.CUDA_CORE),
])
def test_conv2d_route(dtype, C, F, route):
    assert conv2d.conv2d_route(dtype, C, F) == route
    # the dgrad (F -> C on flip-swapped weights) takes the forward's route
    assert conv2d.conv2d_route(dtype, F, C) == route


@pytest.mark.parametrize("dtype,C,F", [
    (torch.bfloat16, 16, 8), (torch.bfloat16, 24, 40),
    (torch.bfloat16, 20, 36), (torch.float32, 16, 8)])
def test_wrappers_launch_the_kernels_of_their_route(monkeypatch, dtype, C, F):
    """With the C entries recorded in place of the card: conv2d_same,
    conv2d_dgrad and conv2d_wgrad launch the entries conv2d_route names,
    once each, on the inputs' device, and count each launch under its
    kernel; the tensor-core dgrad passes the forward's weights with the
    flip, and every tensor-core forward its output-channel tile (fp32
    there takes the TF32 route: ``test_torch_conv2d_tf32.py`` records its
    entries' arguments)."""
    calls = []

    def record(name, *args, device):
        calls.append((name, args, device))

    monkeypatch.setattr(conv2d._build, "call", record)
    monkeypatch.setattr(conv2d._backend, "uses_kernels", lambda t: True)
    monkeypatch.setattr(conv2d, "launches", dict.fromkeys(conv2d.launches, 0))
    x = torch.zeros(1, 5, 6, C, dtype=dtype)
    g = torch.zeros(1, 5, 6, F, dtype=dtype)
    w = torch.zeros(F, C, 3, 3, dtype=dtype)
    assert conv2d.conv2d_same_cuda(x, w).shape == (1, 5, 6, F)
    assert conv2d.conv2d_dgrad_cuda(g, w).shape == (1, 5, 6, C)
    assert conv2d.conv2d_wgrad_cuda(x, g).shape == (F, C, 3, 3)
    assert all(dev == x.device for _, _, dev in calls)
    if conv2d.conv2d_route(dtype, C, F) == conv2d.TENSOR_CORE:
        assert [c[0] for c in calls] == ["conv2d_same_fwd_tc",
                                         "conv2d_same_fwd_tc",
                                         "conv2d_wgrad_tc"]
        fwd, dgrad, wgrad = (c[1] for c in calls)
        # x, w, wpk, y, B, H, W, C, F, bn, flip
        assert fwd[4:] == (1, 5, 6, C, F, conv2d.tc2d_tile_n(F)[0], 0)
        assert dgrad[1] == w.data_ptr()
        assert dgrad[4:] == (1, 5, 6, F, C, conv2d.tc2d_tile_n(C)[0], 1)
        # x, g, partial, dw, B, H, W, C, F, tiles_per_chunk, n_chunks
        n_tiles = conv2d.pixel_tiles_tc2d(1, 5, 6, C, F)
        assert wgrad[4:] == (1, 5, 6, C, F,
                             *conv2d.wgrad_tc2d_chunking(n_tiles, C, F))
        assert conv2d.launches == dict(
            dict.fromkeys(conv2d.launches, 0), conv2d_same_fwd_tc=1,
            conv2d_dgrad_tc=1, conv2d_wgrad_tc=1)
    elif conv2d.conv2d_route(dtype, C, F) == conv2d.TF32X3:
        assert [c[0] for c in calls] == ["conv2d_same_fwd_tf32",
                                         "conv2d_same_fwd_tf32",
                                         "conv2d_wgrad_tf32"]
        assert conv2d.launches == dict(
            dict.fromkeys(conv2d.launches, 0), conv2d_same_fwd_tf32=1,
            conv2d_dgrad_tf32=1, conv2d_wgrad_tf32=1)
    else:
        assert [c[0] for c in calls] == ["conv2d_same_fwd",
                                         "conv2d_same_fwd", "conv2d_wgrad"]
        # x, w, y, dtype, B, H, W, C, F (the dgrad on flip-swapped weights)
        assert calls[0][1][3:] == (int(dtype == torch.bfloat16), 1, 5, 6,
                                   C, F)
        assert calls[1][1][3:] == (int(dtype == torch.bfloat16), 1, 5, 6,
                                   F, C)
        assert conv2d.launches == dict(
            dict.fromkeys(conv2d.launches, 0), conv2d_same_fwd=1,
            conv2d_dgrad=1, conv2d_wgrad=1)


def test_every_acdc_width_takes_the_tensor_core_route():
    """The ACDC MedFormer-2D with ``conv2d_kernel`` on: its 14 kernel convs
    see 256^2 32 -> 32 (6: inc's block and up4) and 128^2 64 -> 64 (8:
    down1 and up3) on a 256^2 slice, and every one of them, forward and
    dgrad, takes the tensor-core route in bf16 and the TF32 route in fp32
    (no CUDA-core 3x3 launch in either dtype)."""
    model = get_model(config_from_dict(ACDC), device="cpu",
                      generator=torch.Generator().manual_seed(0)).eval()
    shapes = []

    def hook(module, args, out):
        x = args[0]
        shapes.append((x.shape[2], x.shape[3], module.conv.in_channels,
                       module.conv.out_channels))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, ConvNormAct)
               and m.kernel is conv2d.Conv2dSame]
    with torch.no_grad():
        model(torch.zeros(1, 1, 256, 256))
    for h in handles:
        h.remove()
    assert sorted(shapes) == [(128, 128, 64, 64)] * 8 + \
        [(256, 256, 32, 32)] * 6
    for _, _, C, F in shapes:
        for c, f in ((C, F), (F, C)):
            assert conv2d.conv2d_route(torch.bfloat16, c, f) == \
                conv2d.TENSOR_CORE, (c, f)
            assert conv2d.conv2d_route(torch.float32, c, f) == \
                conv2d.TF32X3, (c, f)


@pytest.mark.parametrize("F,bn,n_tiles", [
    (8, 32, 1), (32, 32, 1), (40, 64, 1), (64, 64, 1), (96, 96, 1),
    (128, 64, 2), (160, 96, 2), (192, 96, 2)])
def test_tc2d_tile_n_covers_f_in_at_most_96_wide_tiles(F, bn, n_tiles):
    assert conv2d.tc2d_tile_n(F) == (bn, n_tiles)
    assert bn % 32 == 0 and bn <= conv2d.TC2D_MAX_BN and bn * n_tiles >= F
    assert bn * (n_tiles - 1) < F


# ---------------------------------------------------------------- packing

@pytest.mark.parametrize("C,F", [(16, 8), (24, 40), (40, 24), (8, 160)])
def test_packed_weights_layout(C, F):
    """[n_tiles, chunks, kh, kw, 32, BN + 8], zeros past C, F and in the
    8-value row padding; every weight at its place."""
    rng = np.random.default_rng(C * 7 + F)
    w = torch.from_numpy(rng.normal(size=(F, C, 3, 3)).astype(np.float32))
    wp = conv2d.pack_weights_tc2d(w)
    bn, n_tiles = conv2d.tc2d_tile_n(F)
    n_chunks = -(-C // 32)
    assert tuple(wp.shape) == (n_tiles, n_chunks, 3, 3, 32, bn + 8)
    assert wp.is_contiguous() and wp.dtype == w.dtype
    assert float(wp[..., bn:].abs().max()) == 0.0
    f, c = F - 1, C - 1
    assert wp[f // bn, c // 32, 2, 0, c % 32, f % bn] == w[f, c, 2, 0]
    assert float(wp.abs().sum()) == pytest.approx(float(w.abs().sum()),
                                                  rel=1e-6)


@pytest.mark.parametrize("C,F", [(16, 8), (24, 40), (8, 160)])
def test_packed_weights_flip_swap(C, F):
    """With ``flip``, the packing of ``flip_swap(w)``: output channels C,
    input channels F, taps reversed (what the entry's packing kernel does
    for the dgrad)."""
    rng = np.random.default_rng(C * 5 + F)
    w = torch.from_numpy(rng.normal(size=(F, C, 3, 3)).astype(np.float32))
    wp = conv2d.pack_weights_tc2d(w, flip=True)
    torch.testing.assert_close(wp,
                               conv2d.pack_weights_tc2d(conv2d.flip_swap(w)),
                               rtol=0, atol=0)
    bn, n_tiles = conv2d.tc2d_tile_n(C)
    assert tuple(wp.shape) == (n_tiles, -(-F // 32), 3, 3, 32, bn + 8)
    for a, b, kh, kw in ((C - 1, F - 1, 0, 1), (0, F // 2, 2, 2)):
        assert wp[a // bn, b // 32, kh, kw, b % 32, a % bn] == \
            w[b, a, 2 - kh, 2 - kw]


@pytest.mark.parametrize("C,F", WIDTHS)
def test_packed_plain_conv_matches_plain_and_pallas(C, F):
    """A plain conv from the packed weights (the tensor-core kernel's
    arithmetic) equals ``conv2d_same_plain`` and the Pallas ``conv2d_same``
    in interpret mode, fp32; with the flip it is the dgrad."""
    rng = np.random.default_rng(C + 3 * F)
    x = rng.normal(size=(*SHAPE, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3)) / np.sqrt(9 * C)).astype(np.float32)
    g = rng.normal(size=(*SHAPE, F)).astype(np.float32)
    tx, tw, tg = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g)
    y = conv2d.conv2d_same_packed_plain(tx, conv2d.pack_weights_tc2d(tw), F)
    ref = jax_conv2d_same(jnp.asarray(x), jnp.asarray(_w_to_jax(w)),
                          interpret=True)
    # fp32 everywhere; 9 * C products summed in other orders
    torch.testing.assert_close(y, conv2d.conv2d_same_plain(tx, tw),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    dx = conv2d.conv2d_same_packed_plain(
        tg, conv2d.pack_weights_tc2d(tw, flip=True), C)
    torch.testing.assert_close(dx, conv2d.conv2d_dgrad(tg, tw), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------ bf16 parity (plain)

@pytest.mark.parametrize("C,F", WIDTHS)
def test_bf16_conv2d_same_matches_pallas(C, F):
    (x, w, _), (jx, jw, _) = _bf16_inputs(C, F, C)
    y = conv2d.conv2d_same(x, w)
    assert y.dtype == torch.bfloat16 and y.shape == (*SHAPE, F)
    ref = jax_conv2d_same(jx, jw, interpret=True)
    _close(y, ref, BF16_TOL)
    _close(conv2d.conv2d_same_packed_plain(x, conv2d.pack_weights_tc2d(w), F),
           ref, BF16_TOL)


@pytest.mark.parametrize("C,F", WIDTHS)
def test_bf16_conv2d_dgrad_matches_pallas_vjp(C, F):
    """dx of the Pallas VJP (the forward kernel on flip-swapped weights)."""
    (_, w, g), (jx, jw, jg) = _bf16_inputs(C, F, C + 1)
    _, vjp = jax.vjp(jax_conv2d_same_t, jx, jw)
    dx_j, _ = vjp(jg)
    dx = conv2d.conv2d_dgrad(g, w)
    assert dx.dtype == torch.bfloat16 and dx.shape == (*SHAPE, C)
    _close(dx, dx_j, BF16_TOL)
    _close(conv2d.conv2d_same_packed_plain(
        g, conv2d.pack_weights_tc2d(w, flip=True), C), dx_j, BF16_TOL)


@pytest.mark.parametrize("C,F", WIDTHS)
def test_bf16_conv2d_wgrad_matches_pallas(C, F):
    (x, _, g), (jx, _, jg) = _bf16_inputs(C, F, C + 2)
    dw = conv2d.conv2d_wgrad(x, g)
    assert dw.dtype == torch.float32 and dw.shape == (F, C, 3, 3)
    ref = jax_conv2d_wgrad(jx, jg, interpret=True)
    _close(torch.from_numpy(_w_to_jax(dw.numpy())), ref, WGRAD_TOL)


@pytest.mark.parametrize("C,F", WIDTHS)
def test_bf16_conv2d_same_grads_match_pallas_vjp(C, F):
    """Conv2dSame's backward in bf16 against the Pallas VJP: dx, and dW,
    which both round from fp32 to w's bf16 once (one ulp, 2^-8 of max)."""
    (x, w, g), (jx, jw, jg) = _bf16_inputs(C, F, C + 3)
    _, vjp = jax.vjp(jax_conv2d_same_t, jx, jw)
    dx_j, dw_j = vjp(jg)
    tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
    conv2d.Conv2dSame.apply(tx, tw).backward(g)
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    _close(tx.grad, dx_j, BF16_TOL)
    _close(torch.from_numpy(_w_to_jax(tw.grad.float().numpy())), dw_j,
           BF16_TOL)


# --------------------------------------------------------------- chunking

@pytest.mark.parametrize("shape,C,F", [
    ((32, 256, 256), 32, 32), ((32, 128, 128), 64, 64),
    ((12, 256, 256), 32, 32), ((4, 64, 64), 192, 160),
    ((3, 37, 50), 24, 40), ((1, 1, 1), 8, 8), ((32, 256, 256), 32, 64)])
def test_wgrad_tc2d_chunking_covers_every_pixel_within_the_cap(shape, C, F):
    B, H, W = shape
    tc, tf, th = conv2d.wgrad_tc2d_tiles(C, F)
    assert tc >= min(C, 32) and tf >= min(F, 32) and th in (4, 8)
    assert (tc, tf, th) == ((32, 32, 8) if C <= 32 and F <= 32 else
                            (32 if C <= 32 else 64, 32 if F <= 32 else 64, 4))
    n_tiles = conv2d.pixel_tiles_tc2d(B, H, W, C, F)
    assert n_tiles == B * -(-H // th) * -(-W // conv2d.TC2D_TILE_W)
    assert n_tiles * th * conv2d.TC2D_TILE_W >= B * H * W
    per, n_chunks = conv2d.wgrad_tc2d_chunking(n_tiles, C, F)
    # every tile in exactly one chunk, no chunk empty
    assert per * n_chunks >= n_tiles > per * (n_chunks - 1)
    assert 1 <= n_chunks <= 65535
    assert n_chunks * 9 * C * F * 4 <= _WGRAD_MAX_PARTIAL_BYTES
    # about one block an SM over the (c, f) tiles of dW
    blocks = n_chunks * -(-C // tc) * -(-F // tf)
    assert blocks <= max(132, -(-C // tc) * -(-F // tf))


def test_wgrad_tc2d_chunking_respects_the_partial_cap():
    """At every width of the route up to 512 and beyond the card's SM
    count of dW tiles, at the ACDC pixel count: the fp32 partials stay
    within the cap, at most one dW when one chunk is left."""
    n_tiles = conv2d.pixel_tiles_tc2d(32, 256, 256, 64, 64)
    for C in range(8, 520, 56):
        for F in (8, 32, 64, 96, 256, 512, 1024):
            per, n_chunks = conv2d.wgrad_tc2d_chunking(n_tiles, C, F)
            assert per * n_chunks >= n_tiles > per * (n_chunks - 1)
            assert n_chunks * 9 * C * F * 4 <= _WGRAD_MAX_PARTIAL_BYTES
            tc, tf, _ = conv2d.wgrad_tc2d_tiles(C, F)
            if -(-C // tc) * -(-F // tf) > 132:
                assert n_chunks == 1
