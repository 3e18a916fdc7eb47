"""The TF32 route's weight gradient (3xTF32), on the CPU.

fp32 CUDA calls of ``conv3d_wgrad`` at widths of multiples of 8 launch
``conv3d_wgrad_tf32`` (``csrc/conv3d_wgrad_tf32.cu``): x and g each split
into a TF32 hi and lo part, three TF32 tensor-core products summed in fp32,
split-K over chunks of (4, 8, 8) voxel tiles.  The kernel runs only on the
card (``chip_smoke.py`` phase 3 holds it against its plain version and an
fp64 weight gradient).  Here its arithmetic, ``conv3d_wgrad_tf32x3_plain``,
is held against an fp64 ``conv3d_weight`` and the JAX package's Pallas
``conv3d_wgrad`` in interpret mode; a single TF32 pass is shown to fail the
same tolerance; the chunking and the wrapper's launch are checked with the
launch recorded in place of the card.  Inputs come from numpy with a seed,
on a volume that fills no voxel tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.ops.pallas.conv3d import conv3d_wgrad as jax_conv3d_wgrad
from cbim_tpu_torch.ops.kernels import conv3d

#: (B, D, H, W): the backward cases' shape (the Pallas wgrad tiles D by 2
#: and H by 8); the TF32 wgrad's (4, 8, 8) voxel tiles do not divide W
SHAPE = (2, 4, 8, 10)
#: multiples of 8: a c tile half past C (8, 24), a single g plane (16, 8),
#: and both ragged (24, 40)
WIDTHS = [(16, 8), (8, 24), (24, 40)]
#: 3xTF32 against fp64, held against max|dW|: the dropped x_lo g_lo and the
#: rounding of each lo part cost at most 3 * 2^-22 of each product, the fp32
#: sums of 640 products about as much as fp32 itself; one TF32 pass errs by
#: 2^-11 of each product, over 10x this tolerance
TF32X3_TOL = 1e-5


def _inputs(C, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*SHAPE, C)).astype(np.float32)
    g = rng.normal(size=(*SHAPE, F)).astype(np.float32)
    return x, g


def _wgrad64(x, g):
    """torch's [F, C, 3, 3, 3] weight gradient in fp64."""
    return torch.nn.grad.conv3d_weight(
        x.double().permute(0, 4, 1, 2, 3), (g.shape[-1], x.shape[-1], 3, 3, 3),
        g.double().permute(0, 4, 1, 2, 3), padding=1)


def _rel(got, ref):
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("C,F", WIDTHS)
def test_wgrad_tf32x3_plain_matches_fp64_and_pallas(C, F):
    """fp32 accuracy: within TF32X3_TOL of max|dW| of an fp64 weight
    gradient and of the Pallas ``conv3d_wgrad`` in interpret mode (fp32,
    [3, 3, 3, C, F])."""
    x, g = _inputs(C, F, 7 * C + F)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    dw = conv3d.conv3d_wgrad_tf32x3_plain(tx, tg)
    assert dw.dtype == torch.float32 and dw.shape == (F, C, 3, 3, 3)
    assert _rel(dw, _wgrad64(tx, tg)) <= TF32X3_TOL
    ref = np.asarray(jax_conv3d_wgrad(jnp.asarray(x), jnp.asarray(g),
                                      interpret=True))
    assert ref.dtype == np.float32
    assert _rel(dw.permute(2, 3, 4, 1, 0), ref) <= TF32X3_TOL


@pytest.mark.parametrize("C,F", WIDTHS)
def test_single_tf32_wgrad_pass_fails_the_tolerance(C, F):
    """The tolerance sees the split: one TF32 product (x and g rounded to
    TF32 once, as cuDNN's TF32 mode does) errs by more than 10x
    TF32X3_TOL, and so does dropping either compensation term."""
    x, g = _inputs(C, F, 7 * C + F)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    ref = _wgrad64(tx, tg)
    (xh, xl), (gh, gl) = conv3d.tf32_split(tx), conv3d.tf32_split(tg)
    one_pass = conv3d.conv3d_wgrad_plain(xh, gh)
    assert _rel(one_pass, ref) > 10 * TF32X3_TOL
    for partial in (one_pass + conv3d.conv3d_wgrad_plain(xl, gh),
                    one_pass + conv3d.conv3d_wgrad_plain(xh, gl)):
        assert _rel(partial, ref) > 10 * TF32X3_TOL


@pytest.mark.parametrize("operand", ["x", "g"])
@pytest.mark.parametrize("C,F", WIDTHS)
def test_wgrad_tf32x3_plain_keeps_the_nan_mask(C, F, operand):
    """The card's NaN (0x7FFFFFFF) at an interior voxel of x or g makes dW
    NaN exactly where that value enters a product: the weight gradient of
    the NaN's indicator against ones."""
    x, g = _inputs(C, F, 3 * C + F)
    nan = np.array(0x7FFFFFFF, np.uint32).view(np.float32)
    if operand == "x":
        x[1, 2, 3, 4, C // 2] = nan
    else:
        g[0, 1, 5, 7, F // 2] = nan
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    dw = conv3d.conv3d_wgrad_tf32x3_plain(tx, tg)
    where = (conv3d.conv3d_wgrad_plain(tx.isnan().float(), torch.ones_like(tg))
             + conv3d.conv3d_wgrad_plain(torch.ones_like(tx),
                                         tg.isnan().float())) > 0
    assert int(where.sum()) == 27 * (F if operand == "x" else C)
    assert torch.equal(dw.isnan(), where)


@pytest.mark.parametrize("shape,C,F", [
    ((2, 128, 128, 128), 96, 32), ((2, 128, 128, 128), 32, 32),
    ((2, 64, 64, 64), 192, 64), ((2, 32, 32, 32), 128, 128),
    ((2, 17, 23, 30), 24, 40), ((1, 4, 8, 8), 8, 8),
    ((2, 64, 64, 64), 192, 192), ((2, 4, 8, 10), 8, 24)])
def test_wgrad_tf32_chunking_covers_every_voxel_within_the_cap(shape, C, F):
    """Every voxel tile in exactly one chunk, no chunk empty, the blocks
    near 4 waves of the card's 132 SMs (one block an SM) where the tiles
    allow, and the fp32 partials within the cap."""
    n_tiles = conv3d.voxel_tiles(*shape)
    per, n_chunks = conv3d.wgrad_tc_chunking(n_tiles, C, F,
                                             conv3d.TF32_WGRAD_TILE)
    assert per * n_chunks >= n_tiles > per * (n_chunks - 1)
    assert 1 <= n_chunks <= 65535
    assert n_chunks * 27 * C * F * 4 <= conv3d._WGRAD_MAX_PARTIAL_BYTES
    tc, tf = conv3d.TF32_WGRAD_TILE
    blocks = -(-C // tc) * -(-F // tf) * n_chunks
    assert blocks <= max(conv3d._TC_WGRAD_TARGET_BLOCKS,
                         -(-C // tc) * -(-F // tf))
    if n_tiles >= 528:
        assert blocks > conv3d._TC_WGRAD_TARGET_BLOCKS // 2


def test_wgrad_tf32_chunking_respects_the_partial_cap():
    """A dW so wide that one chunk's partials pass a tenth of the cap."""
    C = F = 1024
    per, n_chunks = conv3d.wgrad_tc_chunking(10 ** 6, C, F,
                                             conv3d.TF32_WGRAD_TILE)
    assert n_chunks * 27 * C * F * 4 <= conv3d._WGRAD_MAX_PARTIAL_BYTES
    assert per * n_chunks >= 10 ** 6


@pytest.mark.parametrize("shape,C,F", [((1, 2, 3, 4), 24, 40),
                                       ((2, 17, 23, 30), 96, 32)])
def test_wgrad_tf32_launch_passes_its_entry_the_chunking(monkeypatch, shape,
                                                         C, F):
    """With ``_build.call`` recorded in place of the card: fp32 at widths
    of multiples of 8 calls ``conv3d_wgrad_tf32`` once with x, g, fp32
    scratch of exactly n_chunks * 27 * C * F partials, dW [3, 3, 3, C, F],
    the shape and the chunking of ``wgrad_tc_chunking`` for its tile;
    counts it under its own counter and gives back torch's [F, C, 3, 3,
    3]."""
    calls, made, alive = [], {}, []
    monkeypatch.setattr(conv3d._build, "call",
                        lambda name, *args, device: calls.append(
                            (name, args)))
    monkeypatch.setattr(conv3d._backend, "uses_kernels", lambda t: True)
    empty = torch.empty

    def recorded_empty(*size, **kw):
        t = empty(*size, **kw)
        made[t.data_ptr()] = (tuple(t.shape), t.dtype)
        # kept alive, so that no later tensor is given its address
        alive.append(t)
        return t

    monkeypatch.setattr(conv3d.torch, "empty", recorded_empty)
    x = torch.zeros(*shape, C)
    g = torch.zeros(*shape, F)
    before = dict(conv3d.launches)
    dw = conv3d.conv3d_wgrad(x, g)
    (name, args), = calls
    assert name == "conv3d_wgrad_tf32"
    per, n_chunks = conv3d.wgrad_tc_chunking(conv3d.voxel_tiles(*shape),
                                             C, F, conv3d.TF32_WGRAD_TILE)
    # (x, g, partial, dw, B, D, H, W, C, F, tiles_per_chunk, n_chunks)
    assert args[:2] == (x.data_ptr(), g.data_ptr())
    assert args[4:] == (*shape, C, F, per, n_chunks)
    assert made[args[2]] == ((n_chunks * 27 * C * F,), torch.float32)
    assert made[args[3]] == ((3, 3, 3, C, F), torch.float32)
    assert dw.shape == (F, C, 3, 3, 3) and dw.data_ptr() == args[3]
    moved = {k: conv3d.launches[k] - before[k] for k in before
             if conv3d.launches[k] != before[k]}
    assert moved == {"conv3d_wgrad_tf32": 1}


def test_wgrad_tf32_launch_needs_contiguous_inputs(monkeypatch):
    monkeypatch.setattr(conv3d._build, "call",
                        lambda *a, **k: pytest.fail("launched"))
    x = torch.zeros(1, 2, 3, 8, 4).transpose(3, 4)
    with pytest.raises(ValueError):
        conv3d._launch_wgrad_tf32(x, torch.zeros(1, 2, 3, 4, 8))
