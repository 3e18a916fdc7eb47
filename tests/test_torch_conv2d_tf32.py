"""The TF32 route of the port's 3x3 conv (3xTF32), on the CPU.

fp32 CUDA calls of ``conv2d_same``, ``conv2d_dgrad`` and ``conv2d_wgrad`` at
widths of multiples of 8 launch ``conv2d_same_fwd_tf32``
(``csrc/conv2d_tf32.cu``, also the dgrad on flip-swapped weights) and
``conv2d_wgrad_tf32`` (``csrc/conv2d_wgrad_tf32.cu``): each operand split
into a TF32 hi and lo part, three TF32 tensor-core products summed in fp32.
The kernels run only on the card (``chip_smoke.py`` phase 3 holds them
against their plain versions and an fp64 conv).  Here the route, the
packing of the split weights (and the dgrad's flip), the wgrad's chunking
and the wrappers' launches are checked with the launches recorded in place
of the card, and the arithmetic, ``conv2d_same_tf32x3_plain`` and
``conv2d_wgrad_tf32x3_plain``, is held against fp64 and the JAX package's
Pallas ``conv2d_same``, ``conv2d_same_t`` VJP and ``conv2d_wgrad`` in
interpret mode; a single TF32 pass is shown to fail the same tolerance.
Inputs come from numpy with a seed, on images that fill no tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as nnf

from cbim_tpu.ops.pallas.conv2d import conv2d_same as jax_conv2d_same
from cbim_tpu.ops.pallas.conv2d import conv2d_same_t as jax_conv2d_same_t
from cbim_tpu.ops.pallas.conv2d import conv2d_wgrad as jax_conv2d_wgrad
from cbim_tpu_torch.ops.kernels import conv2d
from cbim_tpu_torch.ops.kernels.conv3d import (_WGRAD_MAX_PARTIAL_BYTES,
                                               TF32_WGRAD_TILE, tf32_split,
                                               tf32_tile_n, wgrad_tc_chunking)

#: (B, H, W) of the Pallas cases: its kernels tile H by 8; the TF32 tiles
#: are (16, 32) and (8, 32) in the forward, (6, 32) in the wgrad, so no
#: image fills one in W
SHAPE = (2, 8, 20)
#: a narrow width (a single g plane in the wgrad) and the ragged one of
#: chip_smoke.py's 3x3 cases (24 channels: a 16-channel chunk with 8 past C)
WIDTHS = [(16, 8), (24, 40)]
#: 3xTF32 against fp64, held against max|y| (max|dW|): the dropped x_lo w_lo
#: and the rounding of each lo part cost at most 3 * 2^-22 of each product,
#: the fp32 sums of 9 C products (320 pixels in the wgrad) about as much as
#: fp32 itself; one TF32 pass errs by 2^-11 of each product, over 10x this
#: tolerance
TF32X3_TOL = 1e-5
#: the card's NaN (what its arithmetic makes) as fp32 bits, and an interior
#: pixel (b, h, w) of SHAPE, so no 3x3 window around it crosses the pad
NAN_BITS = 0x7FFFFFFF
NAN_AT = (1, 3, 11)


def _w_to_jax(w):
    """torch [F, C, 3, 3] -> Pallas [3, 3, C, F]."""
    return np.transpose(w, (2, 3, 1, 0))


def _inputs(C, F, seed):
    """x [B, H, W, C], w [F, C, 3, 3] and g [B, H, W, F], fp32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*SHAPE, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3)) / np.sqrt(9 * C)).astype(np.float32)
    g = rng.normal(size=(*SHAPE, F)).astype(np.float32)
    return x, w, g


def _conv64(x, w):
    """The SAME 3x3 conv in fp64, channels-last."""
    y = nnf.conv2d(x.double().permute(0, 3, 1, 2), w.double(), padding=1)
    return y.permute(0, 2, 3, 1)


def _wgrad64(x, g):
    """torch's [F, C, 3, 3] weight gradient in fp64."""
    return torch.nn.grad.conv2d_weight(
        x.double().permute(0, 3, 1, 2), (g.shape[-1], x.shape[-1], 3, 3),
        g.double().permute(0, 3, 1, 2), padding=1)


def _rel(got, ref):
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float((got - ref).abs().max() / ref.abs().max())


# ------------------------------------------------------------------ route

@pytest.mark.parametrize("dtype,C,F,route", [
    (torch.float32, 32, 32, conv2d.TF32X3),
    (torch.float32, 64, 64, conv2d.TF32X3),
    (torch.float32, 24, 40, conv2d.TF32X3),
    (torch.float32, 8, 192, conv2d.TF32X3),
    (torch.float32, 1, 32, conv2d.CUDA_CORE),
    (torch.float32, 20, 36, conv2d.CUDA_CORE),
    (torch.float32, 32, 4, conv2d.CUDA_CORE),
])
def test_tf32_route(dtype, C, F, route):
    """fp32 at widths of multiples of 8 takes the TF32 route, every other
    fp32 width (a 1-channel input among them) the CUDA cores; the dgrad
    (F -> C) takes its forward's.  bf16's routes: ``test_conv2d_route``
    of ``test_torch_conv2d_tc.py``."""
    assert conv2d.conv2d_route(dtype, C, F) == route
    assert conv2d.conv2d_route(dtype, F, C) == route


# ---------------------------------------------------------------- packing

def _unpack(wp, C, F):
    """hi and lo as torch weights [F, C, 3, 3] from the packed layout."""
    n_tiles, n_chunks, _, _, _, bn, _ = wp.shape
    parts = wp[..., :16].permute(3, 0, 5, 1, 6, 2, 4)
    parts = parts.reshape(2, n_tiles * bn, n_chunks * 16, 3, 3)
    return parts[0, :F, :C], parts[1, :F, :C]


@pytest.mark.parametrize("C,F", [(16, 8), (24, 40), (40, 24), (8, 192)])
def test_packed_tf32_2d_weights_layout(C, F):
    """[n_tiles, chunks, kh, part, kw, BN, 20]: every weight's hi and lo at
    their place (they are ``tf32_split(w)``), zeros past C, F and in the
    4-value row padding."""
    rng = np.random.default_rng(C * 7 + F)
    w = torch.from_numpy(rng.normal(size=(F, C, 3, 3)).astype(np.float32))
    wp = conv2d.pack_weights_tf32_2d(w)
    bn, n_tiles = tf32_tile_n(F)
    n_chunks = -(-C // 16)
    assert tuple(wp.shape) == (n_tiles, n_chunks, 3, 2, 3, bn, 20)
    assert wp.is_contiguous() and wp.dtype == torch.float32
    assert float(wp[..., 16:].abs().max()) == 0.0
    hi, lo = tf32_split(w)
    f, c = F - 1, C - 1
    assert wp[f // bn, c // 16, 2, 0, 1, f % bn, c % 16] == hi[f, c, 2, 1]
    assert wp[f // bn, c // 16, 2, 1, 1, f % bn, c % 16] == lo[f, c, 2, 1]
    got_hi, got_lo = _unpack(wp, C, F)
    assert torch.equal(got_hi, hi) and torch.equal(got_lo, lo)
    # nothing else: the padding past C and F is zero
    total = float(hi.abs().sum() + lo.abs().sum())
    assert float(wp.abs().sum()) == pytest.approx(total, rel=1e-6)


@pytest.mark.parametrize("C,F", WIDTHS)
def test_packed_tf32_2d_weights_flip_is_the_dgrads(C, F):
    """With ``flip`` the forward weights pack as flip_swap(w): w[f, c, kh,
    kw] lands at input channel f, output channel c, taps reversed."""
    rng = np.random.default_rng(C + F)
    w = torch.from_numpy(rng.normal(size=(F, C, 3, 3)).astype(np.float32))
    wp = conv2d.pack_weights_tf32_2d(w, flip=True)
    assert torch.equal(wp, conv2d.pack_weights_tf32_2d(conv2d.flip_swap(w)))
    assert wp.shape[-2] == tf32_tile_n(C)[0]
    hi, lo = _unpack(wp, F, C)
    ref_hi, ref_lo = tf32_split(w)
    assert torch.equal(hi[C - 1, F - 1, 0, 1], ref_hi[F - 1, C - 1, 2, 1])
    assert torch.equal(hi, conv2d.flip_swap(ref_hi))
    assert torch.equal(lo, conv2d.flip_swap(ref_lo))


@pytest.mark.parametrize("C,F", WIDTHS)
def test_conv_from_packed_planes_is_the_tf32x3_model(C, F):
    """The three products from the packed planes (the kernel's operands)
    equal the plain 3xTF32 model, forward and dgrad."""
    x, w, g = (torch.from_numpy(a) for a in _inputs(C, F, 2 * C + F))
    for flip, inp, c_in, f_out in ((False, x, C, F), (True, g, F, C)):
        hi, lo = _unpack(conv2d.pack_weights_tf32_2d(w, flip=flip), c_in,
                         f_out)
        xh, xl = tf32_split(inp)
        y = (conv2d.conv2d_same_plain(xl, hi) + conv2d.conv2d_same_plain(
            xh, lo) + conv2d.conv2d_same_plain(xh, hi))
        ws = conv2d.flip_swap(w) if flip else w
        torch.testing.assert_close(
            y, conv2d.conv2d_same_tf32x3_plain(inp, ws), rtol=0, atol=0)


# ------------------------------------------------- the plain 3xTF32 models

@pytest.mark.parametrize("C,F", WIDTHS)
def test_tf32x3_forward_and_dgrad_match_fp64_and_pallas(C, F):
    """fp32 accuracy: the forward within TF32X3_TOL of max|y| of an fp64
    conv and of the Pallas ``conv2d_same`` (interpret, fp32); the dgrad (the
    model on flip-swapped weights) of an fp64 conv and of dx of the Pallas
    ``conv2d_same_t`` VJP."""
    x, w, g = _inputs(C, F, C + 5 * F)
    tx, tw, tg = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g)
    y = conv2d.conv2d_same_tf32x3_plain(tx, tw)
    assert y.dtype == torch.float32 and y.shape == (*SHAPE, F)
    assert _rel(y, _conv64(tx, tw)) <= TF32X3_TOL
    jw = jnp.array(_w_to_jax(w))
    ref = jax_conv2d_same(jnp.array(x), jw, interpret=True)
    assert _rel(y, np.array(ref)) <= TF32X3_TOL
    ws = conv2d.flip_swap(tw)
    dx = conv2d.conv2d_same_tf32x3_plain(tg, ws)
    assert dx.shape == (*SHAPE, C)
    assert _rel(dx, _conv64(tg, ws)) <= TF32X3_TOL
    _, vjp = jax.vjp(jax_conv2d_same_t, jnp.array(x), jw)
    dx_j, _ = vjp(jnp.array(g))
    assert dx_j.dtype == jnp.float32
    assert _rel(dx, np.array(dx_j)) <= TF32X3_TOL


@pytest.mark.parametrize("C,F", WIDTHS)
def test_tf32x3_wgrad_matches_fp64_and_pallas(C, F):
    """fp32 accuracy: within TF32X3_TOL of max|dW| of an fp64 weight
    gradient and of the Pallas ``conv2d_wgrad`` in interpret mode (fp32,
    [3, 3, C, F])."""
    x, _, g = _inputs(C, F, 7 * C + F)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    dw = conv2d.conv2d_wgrad_tf32x3_plain(tx, tg)
    assert dw.dtype == torch.float32 and dw.shape == (F, C, 3, 3)
    assert _rel(dw, _wgrad64(tx, tg)) <= TF32X3_TOL
    ref = np.array(jax_conv2d_wgrad(jnp.array(x), jnp.array(g),
                                      interpret=True))
    assert ref.dtype == np.float32
    assert _rel(dw.permute(2, 3, 1, 0), ref) <= TF32X3_TOL


@pytest.mark.parametrize("C,F", WIDTHS)
def test_single_tf32_pass_fails_the_tolerance(C, F):
    """The tolerance sees the split: one TF32 product (both operands
    rounded to TF32 once, as cuDNN's TF32 mode does) errs by more than 10x
    TF32X3_TOL, in the forward and the wgrad, and so does dropping either
    compensation term."""
    x, w, g = (torch.from_numpy(a) for a in _inputs(C, F, C + 5 * F))
    (xh, xl), (wh, wl), (gh, gl) = tf32_split(x), tf32_split(w), tf32_split(g)
    for fn, a, b, (ah, al), (bh, bl), ref in (
            (conv2d.conv2d_same_plain, x, w, (xh, xl), (wh, wl),
             _conv64(x, w)),
            (conv2d.conv2d_wgrad_plain, x, g, (xh, xl), (gh, gl),
             _wgrad64(x, g))):
        one_pass = fn(ah, bh)
        assert _rel(one_pass, ref) > 10 * TF32X3_TOL
        for partial in (one_pass + fn(al, bh), one_pass + fn(ah, bl)):
            assert _rel(partial, ref) > 10 * TF32X3_TOL


def _nan():
    return float(np.array(NAN_BITS, np.uint32).view(np.float32))


@pytest.mark.parametrize("C,F", WIDTHS)
def test_tf32x3_models_keep_the_nan_mask(C, F):
    """The card's NaN in one input channel of an interior pixel makes the
    forward and the dgrad NaN in every output channel of the 3x3 pixels
    around it and nowhere else, and the wgrad NaN exactly where that value
    enters a product (the weight gradient of the NaNs' indicator against
    ones)."""
    x, w, g = (torch.from_numpy(a) for a in _inputs(C, F, 5 * C + F))
    x[(*NAN_AT, C // 2)] = _nan()
    g[(*NAN_AT, F // 2)] = _nan()
    for t, wt in ((x, w), (g, conv2d.flip_swap(w))):
        around = nnf.max_pool2d(t.isnan().any(-1).float()[:, None], 3,
                                stride=1, padding=1)[:, 0, ..., None] > 0
        assert int(around.sum()) == 9
        y = conv2d.conv2d_same_tf32x3_plain(t, wt)
        assert torch.equal(y.isnan(), around.expand_as(y))
    for xs, gs in ((x, g.nan_to_num()), (x.nan_to_num(), g)):
        dw = conv2d.conv2d_wgrad_tf32x3_plain(xs, gs)
        where = (conv2d.conv2d_wgrad_plain(xs.isnan().float(),
                                           torch.ones_like(gs))
                 + conv2d.conv2d_wgrad_plain(torch.ones_like(xs),
                                             gs.isnan().float())) > 0
        assert int(where.sum()) == 9 * (F if xs is x else C)
        assert torch.equal(dw.isnan(), where)


# ------------------------------------------------ the wrappers' launches

@pytest.mark.parametrize("shape,C,F", [((1, 5, 6), 24, 40),
                                       ((3, 37, 50), 16, 8)])
def test_tf32_wrappers_pass_their_entries(monkeypatch, shape, C, F):
    """With ``_build.call`` recorded in place of the card: fp32 at widths
    of multiples of 8 calls ``conv2d_same_fwd_tf32`` (forward; the dgrad
    with the forward's weights and flip 1) with the tile of ``tf32_tile_n``
    and scratch for exactly the packed weights, and ``conv2d_wgrad_tf32``
    with fp32 scratch of exactly n_chunks * 9 * C * F partials, dW [3, 3,
    C, F] and the chunking of ``wgrad_tc_chunking`` at 9 taps over the
    (6, 32) pixel tiles; it counts each
    launch under its own counter, gives back torch's layouts and never
    calls another entry."""
    calls, made, alive = [], {}, []
    monkeypatch.setattr(conv2d._build, "call",
                        lambda name, *args, device: calls.append(
                            (name, args, device)))
    monkeypatch.setattr(conv2d._backend, "uses_kernels", lambda t: True)
    monkeypatch.setattr(conv2d, "launches", dict.fromkeys(conv2d.launches, 0))
    empty = torch.empty

    def recorded_empty(*size, **kw):
        t = empty(*size, **kw)
        made[t.data_ptr()] = (tuple(t.shape), t.dtype)
        # kept alive, so that no later tensor is given its address
        alive.append(t)
        return t

    monkeypatch.setattr(conv2d.torch, "empty", recorded_empty)
    x = torch.zeros(*shape, C)
    g = torch.zeros(*shape, F)
    w = torch.zeros(F, C, 3, 3)
    assert conv2d.conv2d_same(x, w).shape == (*shape, F)
    assert conv2d.conv2d_dgrad(g, w).shape == (*shape, C)
    dw = conv2d.conv2d_wgrad(x, g)
    assert [c[0] for c in calls] == ["conv2d_same_fwd_tf32"] * 2 + [
        "conv2d_wgrad_tf32"]
    assert all(dev == x.device for _, _, dev in calls)
    fwd, dgrad, wgrad = (c[1] for c in calls)
    # x, w, wpk, y, B, H, W, C, F, bn, flip
    assert fwd[:2] == (x.data_ptr(), w.data_ptr())
    assert fwd[4:] == (*shape, C, F, tf32_tile_n(F)[0], 0)
    assert dgrad[:2] == (g.data_ptr(), w.data_ptr())
    assert dgrad[4:] == (*shape, F, C, tf32_tile_n(C)[0], 1)
    for args, flip in ((fwd, False), (dgrad, True)):
        packed = conv2d.pack_weights_tf32_2d(w, flip=flip)
        assert made[args[2]] == ((packed.numel(),), torch.float32)
    # x, g, partial, dw, B, H, W, C, F, tiles_per_chunk, n_chunks
    per, n_chunks = wgrad_tc_chunking(
        conv2d.pixel_tiles_tf32_2d(*shape), C, F, TF32_WGRAD_TILE, taps=9)
    assert wgrad[:2] == (x.data_ptr(), g.data_ptr())
    assert wgrad[4:] == (*shape, C, F, per, n_chunks)
    assert made[wgrad[2]] == ((n_chunks * 9 * C * F,), torch.float32)
    assert made[wgrad[3]] == ((3, 3, C, F), torch.float32)
    assert dw.shape == (F, C, 3, 3) and dw.data_ptr() == wgrad[3]
    assert conv2d.launches == dict(
        dict.fromkeys(conv2d.launches, 0), conv2d_same_fwd_tf32=1,
        conv2d_dgrad_tf32=1, conv2d_wgrad_tf32=1)


def test_tf32_launches_need_contiguous_inputs(monkeypatch):
    monkeypatch.setattr(conv2d._build, "call",
                        lambda *a, **k: pytest.fail("launched"))
    x = torch.zeros(1, 2, 8, 3).transpose(2, 3)
    w = torch.zeros(8, 8, 3, 3)
    with pytest.raises(ValueError):
        conv2d._launch_fwd_tf32(x, w, "conv2d_same_fwd_tf32")
    with pytest.raises(ValueError):
        conv2d._launch_wgrad_tf32(x, torch.zeros(1, 2, 3, 8))


# --------------------------------------------------------------- chunking

@pytest.mark.parametrize("shape,C,F", [
    ((32, 256, 256), 32, 32), ((32, 128, 128), 64, 64),
    ((12, 256, 256), 32, 32), ((4, 64, 64), 192, 160),
    ((3, 37, 50), 24, 40), ((1, 1, 1), 8, 8), ((2, 8, 20), 16, 8)])
def test_wgrad_tf32_2d_chunking_covers_every_pixel_within_the_cap(shape, C,
                                                                   F):
    """Every pixel in a (6, 32) tile, every tile in exactly one chunk, no
    chunk empty, about 4 waves of one block on each of 132 SMs where the
    tiles allow, and the fp32 partials within the cap."""
    B, H, W = shape
    n_tiles = conv2d.pixel_tiles_tf32_2d(B, H, W)
    assert n_tiles == B * -(-H // 6) * -(-W // 32)
    assert n_tiles * 6 * 32 >= B * H * W
    per, n_chunks = wgrad_tc_chunking(n_tiles, C, F, TF32_WGRAD_TILE,
                                      taps=9)
    assert per * n_chunks >= n_tiles > per * (n_chunks - 1)
    assert 1 <= n_chunks <= 65535
    assert n_chunks * 9 * C * F * 4 <= _WGRAD_MAX_PARTIAL_BYTES
    blocks = -(-C // 16) * -(-F // 32) * n_chunks
    assert blocks <= max(528, -(-C // 16) * -(-F // 32))
    if n_tiles >= 528:
        assert blocks > 528 // 2


def test_wgrad_tf32_2d_chunking_respects_the_partial_cap():
    """At every width of the route up to 1024, at the ACDC pixel count: the
    tiles covered, the fp32 partials within the cap, and one chunk where
    dW has more (c, f) tiles than 528 blocks."""
    n_tiles = conv2d.pixel_tiles_tf32_2d(32, 256, 256)
    for C in range(8, 1032, 120):
        for F in (8, 32, 64, 96, 256, 512, 1024):
            per, n_chunks = wgrad_tc_chunking(n_tiles, C, F,
                                              TF32_WGRAD_TILE, taps=9)
            assert per * n_chunks >= n_tiles > per * (n_chunks - 1)
            assert n_chunks * 9 * C * F * 4 <= _WGRAD_MAX_PARTIAL_BYTES
            if -(-C // 16) * -(-F // 32) > 528:
                assert n_chunks == 1
