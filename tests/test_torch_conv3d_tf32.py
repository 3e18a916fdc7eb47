"""The TF32 route of the port's 3^3 conv (3xTF32), on the CPU.

fp32 CUDA calls of ``conv3d_same``, ``conv3d_dgrad`` and ``conv3d_same_na``
at widths of multiples of 8 launch ``conv3d_same_fwd_tf32`` and
``conv3d_same_na_fwd_tf32`` (``csrc/conv3d_tf32.cu``): each operand split
into a TF32 hi and lo part, three TF32 tensor-core products summed in fp32.
The kernels run only on the card (``chip_smoke.py`` phase 3 holds them
against their plain versions and an fp64 conv).  Here their arithmetic,
``conv3d_same_tf32x3_plain``, is held against an fp64 conv and the JAX
package's Pallas ``conv3d_same`` and ``conv3d_same_cw_na`` in interpret
mode; a single TF32 pass is shown to fail the same tolerance; the packing
of the split weights (and the dgrad's flip) and the wrappers' launches are
checked with the launches recorded in place of the card.  Inputs come from
numpy with a seed (mean 1.5 for the fused conv, so that a padding
normalised to act(-mean * rstd) instead of 0 fails), on volumes that do not
fill a tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as nnf

from cbim_tpu.ops.pallas.conv3d import conv3d_same as jax_conv3d_same
from cbim_tpu.ops.pallas.conv3d import conv3d_same_cw_na, from_cw, to_cw
from cbim_tpu_torch.ops.kernels import conv3d
from test_torch_threads import few_torch_threads  # noqa: F401

EPS = 1e-4
ACTS = [None, "relu", "gelu"]
#: (B, D, H, W) of the Pallas cases: its kernels tile D by 2 and H by 8;
#: the TF32 boxes are (4, 8, 16) and (4, 8, 8), so no volume fills one
SHAPE = (2, 4, 8, 10)
NA_SHAPE = (2, 4, 8, 12)
#: the widths of test_torch_conv3d_tc.py: a narrow one and the ragged one
#: of chip_smoke.py's conv cases (24 channels: a 16-channel chunk with 8
#: past C)
WIDTHS = [(16, 8), (24, 40)]
#: 3xTF32 against fp64, held against max|y|: the dropped x_lo w_lo and the
#: rounding of each lo part cost at most 3 * 2^-22 of each product, the fp32
#: sums of 27 C products about as much as fp32 itself (the plain fp32 conv
#: errs by 0.5-1.2e-6 of max|y| at these widths); one TF32 pass errs by
#: 2^-11 of each product, 3-4e-4 of max|y| here, 30x this tolerance
TF32X3_TOL = 1e-5


def _w_to_jax(w):
    """torch [F, C, 3, 3, 3] -> Pallas [3, 3, 3, C, F]."""
    return np.transpose(w, (2, 3, 4, 1, 0))


def _inputs(shape, C, F, seed, loc=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=loc, scale=scale, size=(*shape, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3, 3)) / np.sqrt(27 * C)).astype(np.float32)
    return x, w


def _conv64(x, w):
    """The SAME conv in fp64, channels-last."""
    y = nnf.conv3d(x.double().permute(0, 4, 1, 2, 3), w.double(), padding=1)
    return y.permute(0, 2, 3, 4, 1)


def _stats(x):
    """(mean, rstd) float32 [B, C] from fp64, as torch tensors, and the JAX
    stat [B, 2, C, 1]."""
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(1, 2, 3)).astype(np.float32)
    rstd = (1.0 / np.sqrt(x64.var(axis=(1, 2, 3)) + EPS)).astype(np.float32)
    stat = jnp.asarray(np.stack([mean, rstd], axis=1)[..., None])
    return torch.from_numpy(mean), torch.from_numpy(rstd), stat


def _rel(got, ref):
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float((got - ref).abs().max() / ref.abs().max())


def _low_bits(t):
    """The 13 mantissa bits TF32 drops, of each value."""
    return t.contiguous().view(torch.int32) & 0x1FFF


# ------------------------------------------------------- TF32 rounding

def test_tf32_round_is_round_to_nearest_ties_away():
    """cvt.rna: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10 and rounds
    away from zero, in both signs; below halfway it rounds down; TF32
    values are fixed points."""
    t = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                      1 + 2 ** -12, 1 + 2 ** -10, 0.0, -2.5, 1e-30])
    r = conv3d.tf32_round(t)
    assert r.tolist()[:6] == [1.0, 1 + 2 ** -10, -(1 + 2 ** -10),
                              1 + 2 ** -9, 1.0, 1 + 2 ** -10]
    assert r.tolist()[6:8] == [0.0, -2.5]
    assert int(_low_bits(r).abs().max()) == 0
    assert torch.equal(conv3d.tf32_round(r), r)


#: NaNs as fp32 bits: the card's own (0x7FFFFFFF, and negative), the
#: quiet NaN, and one whose payload lies in the 13 bits TF32 drops
NANS = [0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0x7F800001]
#: an interior voxel (b, d, h, w) of SHAPE, so no window crosses the pad
NAN_AT = (1, 2, 3, 4)


def _nan(bits):
    return torch.from_numpy(np.array([bits], np.uint32).view(np.float32))


@pytest.mark.parametrize("bits", NANS)
def test_tf32_round_keeps_nan(bits):
    """A NaN rounds to a NaN whose TF32 bits are a NaN (the add of half
    the dropped range alone carries 0x7FFFFFFF into the sign bit, -0.0);
    its split keeps it in hi, with lo 0, and so does an infinity's."""
    v = _nan(bits)
    assert bool(v.isnan().all())
    r = conv3d.tf32_round(v)
    assert bool(r.isnan().all()) and int(_low_bits(r).abs().max()) == 0
    hi, lo = conv3d.tf32_split(v)
    assert bool(hi.isnan().all()) and lo.tolist() == [0.0]
    inf = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(conv3d.tf32_round(inf), inf)
    hi, lo = conv3d.tf32_split(inf)
    assert torch.equal(hi, inf) and lo.tolist() == [0.0, 0.0]


@pytest.mark.parametrize("C,F", WIDTHS)
def test_tf32x3_plain_keeps_the_nan_mask(C, F):
    """The card's NaN in one input channel of an interior voxel makes y
    NaN in every output channel of the 3^3 voxels around it and nowhere
    else, in the forward and, on the flip-swapped weights, the dgrad."""
    x, w = _inputs(SHAPE, C, F, 5 * C + F)
    g = _inputs(SHAPE, F, C, 5 * C + F + 1)[0]
    for t in (x, g):
        t[(*NAN_AT, t.shape[-1] // 2)] = _nan(0x7FFFFFFF).numpy()[0]
    tw = torch.from_numpy(w)
    for t, wt in ((x, tw), (g, conv3d.flip_swap(tw))):
        t = torch.from_numpy(t)
        around = nnf.max_pool3d(t.isnan().any(-1).float()[:, None], 3,
                                stride=1, padding=1)[:, 0, ..., None] > 0
        assert int(around.sum()) == 27
        y = conv3d.conv3d_same_tf32x3_plain(t, wt)
        assert torch.equal(y.isnan(), around.expand_as(y))


def test_tf32_split_recovers_fp32_to_2_pow_22():
    """hi and lo are TF32 values; hi + lo is v within 2^-22 |v| (lo's own
    rounding), and |lo| <= 2^-11 |v|."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.normal(size=4096) *
                          10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32))
    hi, lo = conv3d.tf32_split(v)
    assert int(_low_bits(hi).abs().max()) == 0
    assert int(_low_bits(lo).abs().max()) == 0
    err = (hi.double() + lo.double() - v.double()).abs()
    assert bool((err <= 2.0 ** -22 * v.double().abs()).all())
    assert bool((lo.abs() <= 2.0 ** -11 * v.abs()).all())


# ------------------------------------------------- the plain 3xTF32 model

@pytest.mark.parametrize("C,F", WIDTHS)
def test_tf32x3_plain_matches_fp64_and_pallas(C, F):
    """fp32 accuracy: within TF32X3_TOL of max|y| of an fp64 conv and of
    the Pallas ``conv3d_same`` in interpret mode (fp32)."""
    x, w = _inputs(SHAPE, C, F, C + 5 * F)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y = conv3d.conv3d_same_tf32x3_plain(tx, tw)
    assert y.dtype == torch.float32 and y.shape == (*SHAPE, F)
    assert _rel(y, _conv64(tx, tw)) <= TF32X3_TOL
    ref = jax_conv3d_same(jnp.asarray(x), jnp.asarray(_w_to_jax(w)),
                          interpret=True)
    assert _rel(y, np.array(ref)) <= TF32X3_TOL


@pytest.mark.parametrize("C,F", WIDTHS)
def test_single_tf32_pass_fails_the_tolerance(C, F):
    """The tolerance sees the split: one TF32 product (x and w rounded to
    TF32 once, as cuDNN's TF32 mode does) errs by more than 10x
    TF32X3_TOL, and so does dropping either compensation term."""
    x, w = _inputs(SHAPE, C, F, C + 5 * F)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ref = _conv64(tx, tw)
    (xh, xl), (wh, wl) = conv3d.tf32_split(tx), conv3d.tf32_split(tw)
    one_pass = conv3d.conv3d_same_plain(xh, wh)
    assert _rel(one_pass, ref) > 10 * TF32X3_TOL
    for partial in (one_pass + conv3d.conv3d_same_plain(xl, wh),
                    one_pass + conv3d.conv3d_same_plain(xh, wl)):
        assert _rel(partial, ref) > 10 * TF32X3_TOL


@pytest.mark.parametrize("C,F", WIDTHS)
@pytest.mark.parametrize("act", ACTS)
def test_fused_tf32x3_plain_matches_fp64_and_pallas(C, F, act):
    """The fused model (the fp32 norm-act, then 3xTF32) against the fp64
    conv of the same normalised input and against ``conv3d_same_cw_na``
    (interpret, fp32) from the same statistics."""
    x, w = _inputs(NA_SHAPE, C, F, 3 * C + F, loc=1.5, scale=2.0)
    mean, rstd, stat = _stats(x)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y = conv3d.conv3d_same_tf32x3_plain(tx, tw, na=(mean, rstd, act))
    assert y.dtype == torch.float32 and y.shape == (*NA_SHAPE, F)
    xn = conv3d._normed(tx, mean, rstd, act)
    assert _rel(y, _conv64(xn, tw)) <= TF32X3_TOL
    ref = from_cw(conv3d_same_cw_na(to_cw(jnp.asarray(x)), stat,
                                    jnp.asarray(_w_to_jax(w)), act,
                                    interpret=True))
    assert ref.dtype == jnp.float32
    assert _rel(y, np.array(ref)) <= TF32X3_TOL
    if act == "relu":
        return  # relu(-mean * rstd) is 0: the padding is right either way
    # a padding normalised to act(-mean * rstd) would be far off
    xpad = nnf.pad(tx, (0, 0, 1, 1, 1, 1, 1, 1))
    bad = conv3d._normed(xpad, mean, rstd, act)
    y_bad = nnf.conv3d(bad.permute(0, 4, 1, 2, 3), tw).permute(0, 2, 3, 4, 1)
    assert _rel(y_bad, y) > 100 * TF32X3_TOL


# ---------------------------------------------------------------- packing

@pytest.mark.parametrize("F,bn,n_tiles", [
    (8, 32, 1), (32, 32, 1), (40, 64, 1), (64, 64, 1), (96, 32, 3),
    (128, 64, 2), (160, 32, 5), (192, 64, 3)])
def test_tf32_tile_n_pads_f_least(F, bn, n_tiles):
    assert conv3d.tf32_tile_n(F) == (bn, n_tiles)
    assert bn * n_tiles >= F > bn * (n_tiles - 1)


def _unpack(wp, C, F):
    """hi and lo as torch weights [F, C, 3, 3, 3] from the packed layout."""
    n_tiles, n_chunks, _, _, _, _, bn, _ = wp.shape
    parts = wp[..., :conv3d.TF32_CHUNK].permute(4, 0, 6, 1, 7, 2, 3, 5)
    parts = parts.reshape(2, n_tiles * bn, n_chunks * conv3d.TF32_CHUNK,
                          3, 3, 3)
    return parts[0, :F, :C], parts[1, :F, :C]


@pytest.mark.parametrize("C,F", [(16, 8), (24, 40), (40, 24), (8, 192)])
def test_packed_tf32_weights_layout(C, F):
    """[n_tiles, chunks, kd, kh, part, kw, BN, 20]: every weight's hi and
    lo at their place (they are ``tf32_split(w)``), zeros past C, F and in
    the 4-value row padding."""
    rng = np.random.default_rng(C * 7 + F)
    w = torch.from_numpy(rng.normal(size=(F, C, 3, 3, 3)).astype(np.float32))
    wp = conv3d.pack_weights_tf32(w)
    bn, n_tiles = conv3d.tf32_tile_n(F)
    n_chunks = -(-C // 16)
    assert tuple(wp.shape) == (n_tiles, n_chunks, 3, 3, 2, 3, bn, 20)
    assert wp.is_contiguous() and wp.dtype == torch.float32
    assert float(wp[..., 16:].abs().max()) == 0.0
    hi, lo = conv3d.tf32_split(w)
    f, c = F - 1, C - 1
    assert wp[f // bn, c // 16, 2, 0, 0, 1, f % bn, c % 16] == hi[f, c, 2, 0, 1]
    assert wp[f // bn, c // 16, 2, 0, 1, 1, f % bn, c % 16] == lo[f, c, 2, 0, 1]
    got_hi, got_lo = _unpack(wp, C, F)
    assert torch.equal(got_hi, hi) and torch.equal(got_lo, lo)
    # nothing else: the padding past C and F is zero
    total = float(hi.abs().sum() + lo.abs().sum())
    assert float(wp.abs().sum()) == pytest.approx(total, rel=1e-6)


@pytest.mark.parametrize("C,F", [(16, 8), (24, 40)])
def test_packed_tf32_weights_flip_is_the_dgrads(C, F):
    """With ``flip`` the forward weights pack as flip_swap(w): w[f, c, kd,
    kh, kw] lands at input channel f, output channel c, taps reversed."""
    rng = np.random.default_rng(C + F)
    w = torch.from_numpy(rng.normal(size=(F, C, 3, 3, 3)).astype(np.float32))
    wp = conv3d.pack_weights_tf32(w, flip=True)
    assert torch.equal(wp, conv3d.pack_weights_tf32(conv3d.flip_swap(w)))
    hi, lo = _unpack(wp, F, C)
    ref_hi, ref_lo = conv3d.tf32_split(w)
    assert torch.equal(hi[C - 1, F - 1, 0, 1, 2], ref_hi[F - 1, C - 1, 2, 1, 0])
    assert torch.equal(hi, conv3d.flip_swap(ref_hi))
    assert torch.equal(lo, conv3d.flip_swap(ref_lo))


@pytest.mark.parametrize("C,F", WIDTHS)
def test_conv_from_packed_planes_is_the_tf32x3_model(C, F):
    """The three products from the packed planes (the kernel's operands)
    equal the plain 3xTF32 model, forward and dgrad."""
    x, w = _inputs(SHAPE, C, F, 2 * C + F)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for flip, inp, c_in, f_out in ((False, tx, C, F),
                                   (True, torch.from_numpy(
                                       _inputs(SHAPE, F, C, 1)[0]), F, C)):
        hi, lo = _unpack(conv3d.pack_weights_tf32(tw, flip=flip), c_in,
                         f_out)
        xh, xl = conv3d.tf32_split(inp)
        y = (conv3d.conv3d_same_plain(xl, hi) + conv3d.conv3d_same_plain(
            xh, lo) + conv3d.conv3d_same_plain(xh, hi))
        ws = conv3d.flip_swap(tw) if flip else tw
        torch.testing.assert_close(
            y, conv3d.conv3d_same_tf32x3_plain(inp, ws), rtol=0, atol=0)


# --------------------------------------------------- the wrappers' launches

def test_tf32_wrappers_pass_their_entries_the_packing(monkeypatch):
    """With ``_build.call`` recorded in place of the card: fp32 at widths
    of multiples of 8 calls ``conv3d_same_fwd_tf32`` (forward; the dgrad
    with the forward's weights and flip 1) and ``conv3d_same_na_fwd_tf32``
    with the tile of ``tf32_tile_n`` and scratch for exactly the packed
    weights, counts each launch under its own counter, and never calls
    another entry."""
    calls = []
    monkeypatch.setattr(conv3d._build, "call",
                        lambda name, *args, device: calls.append(
                            (name, args)))
    monkeypatch.setattr(conv3d._backend, "uses_kernels", lambda t: True)
    C, Fo = 24, 40
    x = torch.zeros(1, 2, 3, 4, C)
    g = torch.zeros(1, 2, 3, 4, Fo)
    w = torch.zeros(Fo, C, 3, 3, 3)
    mean, rstd = torch.zeros(1, C), torch.ones(1, C)
    before = dict(conv3d.launches)
    conv3d.conv3d_same_cuda(x, w)
    conv3d.conv3d_dgrad_cuda(g, w)
    conv3d.conv3d_same_na_cuda(x, mean, rstd, w, "relu")
    assert [c[0] for c in calls] == ["conv3d_same_fwd_tf32"] * 2 + [
        "conv3d_same_na_fwd_tf32"]
    # (x, w, wpk, y, B, D, H, W, C, F, bn, flip)
    assert calls[0][1][4:] == (1, 2, 3, 4, C, Fo, 64, 0)
    assert calls[1][1][4:] == (1, 2, 3, 4, Fo, C, 32, 1)
    # (x, w, wpk, y, mean, rstd, act, B, D, H, W, C, F, bn): relu is 1
    assert calls[2][1][4] == mean.data_ptr()
    assert calls[2][1][6:] == (1, 1, 2, 3, 4, C, Fo, 64)
    moved = {k: conv3d.launches[k] - before[k] for k in before
             if conv3d.launches[k] != before[k]}
    assert moved == {"conv3d_same_fwd_tf32": 1, "conv3d_dgrad_tf32": 1,
                     "conv3d_same_na_fwd_tf32": 1}


@pytest.mark.parametrize("C,F", [(24, 40), (96, 32), (64, 192)])
@pytest.mark.parametrize("flip", [False, True])
def test_tf32_scratch_holds_the_packed_weights(monkeypatch, C, F, flip):
    """The TF32 launcher asks for the tile and the scratch of exactly the
    packed layout, for the forward and the dgrad."""
    asked = []
    monkeypatch.setattr(conv3d, "_launch_packed",
                        lambda x, w, key, flip, na, suffix, bn, numel:
                        asked.append((suffix, bn, numel)))
    w = torch.zeros(F, C, 3, 3, 3)
    x = torch.zeros(1, 2, 3, 4, F if flip else C)
    conv3d._launch_fwd_tf32(x, w, "conv3d_same_fwd_tf32", flip=flip)
    packed = conv3d.pack_weights_tf32(w, flip=flip)
    assert asked == [("tf32", packed.shape[-2], packed.numel())]
    assert packed.shape[-2] == conv3d.tf32_tile_n(C if flip else F)[0]
