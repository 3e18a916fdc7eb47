"""The tensor-core route of the port's fused preact conv, on the CPU.

``conv3d_same_na`` and ``conv3d_wgrad_na`` launch ``conv3d_same_na_fwd_tc``
and ``conv3d_wgrad_na_tc`` for bf16 CUDA tensors at widths of multiples of
8 (``conv3d_route``).  Those kernels stage raw x by TMA and normalise each
staged halo value once in shared memory; they run only on the card
(``chip_smoke.py`` phase 3 holds them against their plain versions).  Here
their decompositions in plain PyTorch (``conv3d_same_na_tiled_plain``,
``conv3d_wgrad_na_tiled_plain``: a halo box per output or voxel tile with
TMA's zero fill, the norm-act on the rows inside the volume only, channels
past C left at zero) are held against the plain versions and against the
JAX package's ``conv3d_same_cw_na`` and ``conv3d_wgrad_cw2_na`` in interpret
mode, and the wrappers' dispatch is recorded with the launches replaced.
Inputs come from numpy with a seed, of mean 1.5, so that a padding
normalised to act(-mean * rstd) instead of 0 fails; the volumes do not fill
a tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.ops.pallas.conv3d import (conv3d_same_cw_na,
                                        conv3d_wgrad_cw2_na, from_cw, to_cw)
from cbim_tpu_torch.ops.kernels import conv3d, fused_norm
from test_torch_threads import few_torch_threads  # noqa: F401

EPS = 1e-4
ACTS = [None, "relu", "gelu"]
#: (B, D, H, W): D, H and W past a whole tile (boxes (4, 8, 16) or (4, 8, 8),
#: voxel tiles (4, 8, 8)), so every box has a ragged edge
SHAPE = (2, 5, 9, 19)
#: (C, F): narrow widths, the ragged 24 -> 40 of chip_smoke.py (a 32-channel
#: chunk with 8 channels past C), and an F of 96 (the 256-voxel box)
WIDTHS = [(8, 16), (16, 8), (24, 40), (16, 96)]
#: the Pallas kernels' layout tiles D by 2 and H by 8
PALLAS_SHAPE = (2, 4, 8, 12)
#: fp32: the tiled model and the plain version sum the same products in
#: other orders (27 C per output, 27 x 1710 voxels per dW entry); held
#: against the largest output or |dW|.  A wrong tap, halo row or channel
#: errs by O(1) of it.
F32_TOL = 1e-5
#: bf16 outputs of fp32 sums rounded once on both sides: where the sums
#: straddle a rounding boundary they differ by one bf16 ulp (2^-8 of the
#: value), held against max|ref|
BF16_TOL = 2 ** -7
#: dW from bf16 normalised inputs (exact products) in fp32 against the
#: Pallas kernel, whose GELU takes an erf polynomial (within 1.5e-7 of
#: erf): where the two normalised values straddle a bf16 rounding boundary
#: they round one ulp (2^-8) apart, and that value's products with g move
#: by 2^-8 of themselves.  A few such flips in a sum of 27 x 768 products;
#: a wrong tap or halo row errs by O(1) of max|dW|.
BF16_WGRAD_TOL = 2e-3


def _inputs(shape, C, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=1.5, scale=2.0, size=(*shape, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3, 3)) / np.sqrt(27 * C)).astype(np.float32)
    g = rng.normal(size=(*shape, F)).astype(np.float32)
    return x, w, g


def _stats(x):
    """(mean, rstd) float32 [B, C] from fp64, as torch tensors, and the JAX
    stat [B, 2, C, 1]."""
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(1, 2, 3)).astype(np.float32)
    rstd = (1.0 / np.sqrt(x64.var(axis=(1, 2, 3)) + EPS)).astype(np.float32)
    stat = jnp.asarray(np.stack([mean, rstd], axis=1)[..., None])
    return torch.from_numpy(mean), torch.from_numpy(rstd), stat


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max())


def _w_to_jax(w):
    """torch [F, C, 3, 3, 3] -> Pallas [3, 3, 3, C, F]."""
    return np.transpose(w, (2, 3, 4, 1, 0))


# ------------------------------------------------------------------ route

@pytest.mark.parametrize("dtype,C,F,route", [
    (torch.bfloat16, 8, 16, conv3d.TENSOR_CORE),
    (torch.bfloat16, 24, 40, conv3d.TENSOR_CORE),
    (torch.bfloat16, 32, 32, conv3d.TENSOR_CORE),
    (torch.bfloat16, 96, 32, conv3d.TENSOR_CORE),
    (torch.bfloat16, 192, 64, conv3d.TENSOR_CORE),
    (torch.bfloat16, 128, 128, conv3d.TENSOR_CORE),
    (torch.float32, 32, 32, conv3d.TF32X3),
    (torch.float32, 96, 32, conv3d.TF32X3),
    (torch.bfloat16, 20, 36, conv3d.CUDA_CORE),
    (torch.bfloat16, 1, 32, conv3d.CUDA_CORE),
])
def test_fused_pair_route(dtype, C, F, route):
    """The fused pair follows conv3d_route: at widths of multiples of 8
    (every width MedFormer-3D fuses) bf16 on the tensor cores and fp32 on
    the TF32 pair, the rest on the CUDA cores."""
    assert conv3d.conv3d_route(dtype, C, F) == route


@pytest.mark.parametrize("dtype,C,F", [
    (torch.bfloat16, 16, 8), (torch.bfloat16, 24, 40),
    (torch.bfloat16, 20, 36), (torch.float32, 16, 8)])
def test_fused_pair_wrappers_launch_their_route(monkeypatch, dtype, C, F):
    """With the launches recorded in place of the card: conv3d_same_na and
    conv3d_wgrad_na pass their statistics and act to the tensor-core
    launchers on that route, on the TF32 route to the TF32 forward and
    wgrad, to the CUDA-core ones otherwise, and launch nothing else."""
    calls = []

    def record(name):
        def launch(*args, **kw):
            na = kw.get("na", args[-1] if args and isinstance(args[-1], tuple)
                        else None)
            key = args[2] if len(args) > 2 and isinstance(args[2], str) \
                else None
            calls.append((name, key, na))
            return torch.empty(0)
        return launch

    for fn in ("_launch_fwd", "_launch_fwd_tc", "_launch_fwd_tf32",
               "_launch_wgrad", "_launch_wgrad_tc", "_launch_wgrad_tf32"):
        monkeypatch.setattr(conv3d, fn, record(fn))
    monkeypatch.setattr(conv3d._backend, "uses_kernels", lambda t: True)
    x = torch.zeros(1, 2, 3, 4, C, dtype=dtype)
    g = torch.zeros(1, 2, 3, 4, F, dtype=dtype)
    w = torch.zeros(F, C, 3, 3, 3, dtype=dtype)
    mean, rstd = torch.zeros(1, C), torch.ones(1, C)
    conv3d.conv3d_same_na_cuda(x, mean, rstd, w, "gelu")
    conv3d.conv3d_wgrad_na_cuda(x, mean, rstd, g, "gelu")
    assert [c[:2] for c in calls] == {
        conv3d.TENSOR_CORE: [("_launch_fwd_tc", "conv3d_same_na_fwd_tc"),
                             ("_launch_wgrad_tc", None)],
        conv3d.TF32X3: [("_launch_fwd_tf32", "conv3d_same_na_fwd_tf32"),
                        ("_launch_wgrad_tf32", None)],
        conv3d.CUDA_CORE: [("_launch_fwd", "conv3d_same_na_fwd"),
                           ("_launch_wgrad", None)],
    }[conv3d.conv3d_route(dtype, C, F)]
    for _, _, na in calls:
        assert na[0] is mean and na[1] is rstd and na[2] == "gelu"


@pytest.mark.parametrize("F,box", [(8, (4, 8, 16)), (32, (4, 8, 16)),
                                   (40, (4, 8, 16)), (64, (4, 8, 16)),
                                   (96, (4, 8, 8)), (128, (4, 8, 8))])
def test_na_tc_box_follows_the_f_tile(F, box):
    """512-voxel boxes at F tiles of up to 64 channels, 256 at 96 and 128."""
    assert conv3d.na_tc_box(F) == box


# --------------------------------------------- the staged halo (padding)

@pytest.mark.parametrize("act", ACTS)
def test_staged_halo_normalises_only_in_volume_rows_and_channels(act):
    """The corner box's halo: rows outside the volume and channels past C
    stay exactly 0 (TMA's zero fill, never normalised), every other value
    is act((x - mean) * rstd) rounded to x's dtype."""
    C = 24
    x, _, _ = _inputs(SHAPE, C, 8, 11)
    mean, rstd, _ = _stats(x)
    tx = torch.from_numpy(x).bfloat16()
    box = conv3d.na_tc_box(32)
    xp, inside, mp, rp = conv3d._na_padded(tx, mean, rstd, box)
    assert xp.shape[-1] == 32 and float(mp[:, C:].abs().max()) == 0
    for at in ((0, 0, 0), (4, 8, 16)):
        hn = conv3d._na_halo(xp, inside, mp, rp, act, box, at)
        assert hn.shape == (2, 6, 10, 18, 32)
        keep = inside[at[0]:at[0] + 6, at[1]:at[1] + 10, at[2]:at[2] + 18]
        assert not bool(keep.all()) and bool(keep.any())
        assert float(hn[:, ~keep].abs().max()) == 0.0
        assert float(hn[..., C:].abs().max()) == 0.0
        # an in-volume value, against the unfused chain
        z, y, w_ = [int(i[0]) for i in torch.nonzero(keep)[:1].T]
        gz, gy, gw = at[0] + z - 1, at[1] + y - 1, at[2] + w_ - 1
        ref = conv3d._normed(tx, mean, rstd, act)[:, gz, gy, gw]
        torch.testing.assert_close(hn[:, z, y, w_, :C], ref.float(),
                                   rtol=0, atol=0)


# ------------------------------------------------ tiled models vs plain

@pytest.mark.parametrize("C,F", WIDTHS)
@pytest.mark.parametrize("act", ACTS)
def test_tiled_forward_matches_plain_fp32(C, F, act):
    x, w, _ = _inputs(SHAPE, C, F, C + F)
    mean, rstd, _ = _stats(x)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y = conv3d.conv3d_same_na_tiled_plain(tx, mean, rstd, tw, act)
    ref = conv3d.conv3d_same_na_plain(tx, mean, rstd, tw, act)
    assert y.shape == ref.shape == (*SHAPE, F) and y.dtype == torch.float32
    assert _rel(y, ref) <= F32_TOL


@pytest.mark.parametrize("C,F", WIDTHS)
@pytest.mark.parametrize("act", ACTS)
def test_tiled_wgrad_matches_plain_fp32(C, F, act):
    x, _, g = _inputs(SHAPE, C, F, 2 * C + F)
    mean, rstd, _ = _stats(x)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    dw = conv3d.conv3d_wgrad_na_tiled_plain(tx, mean, rstd, tg, act)
    ref = conv3d.conv3d_wgrad_na_plain(tx, mean, rstd, tg, act)
    assert dw.shape == ref.shape == (F, C, 3, 3, 3)
    assert dw.dtype == torch.float32
    assert _rel(dw, ref) <= F32_TOL


@pytest.mark.parametrize("C,F", WIDTHS[:3])
@pytest.mark.parametrize("act", ACTS)
def test_tiled_models_match_plain_bf16(C, F, act):
    """In bf16 both round the normalised input once and y once: the
    forward within one bf16 ulp of max|y|, dW (fp32 sums of the same exact
    products) to F32_TOL."""
    x, w, g = _inputs(SHAPE, C, F, 3 * C + F)
    mean, rstd, _ = _stats(x)
    tx, tw, tg = (torch.from_numpy(v).bfloat16() for v in (x, w, g))
    y = conv3d.conv3d_same_na_tiled_plain(tx, mean, rstd, tw, act)
    assert y.dtype == torch.bfloat16
    assert _rel(y, conv3d.conv3d_same_na_plain(tx, mean, rstd, tw, act)) \
        <= BF16_TOL
    dw = conv3d.conv3d_wgrad_na_tiled_plain(tx, mean, rstd, tg, act)
    assert _rel(dw, conv3d.conv3d_wgrad_na_plain(tx, mean, rstd, tg, act)) \
        <= F32_TOL


def test_tiled_models_fail_with_a_normalised_padding(monkeypatch):
    """The tests above see the padding rule: normalising the halo rows
    outside the volume (act(-mean * rstd) instead of 0) moves the forward
    and dW by far more than their tolerances."""
    x, w, g = _inputs(SHAPE, 16, 8, 5)
    mean, rstd, _ = _stats(x)
    tx, tw, tg = (torch.from_numpy(v) for v in (x, w, g))
    keep_all = conv3d._na_padded

    def padded_everywhere(*args):
        xp, inside, mp, rp = keep_all(*args)
        return xp, torch.ones_like(inside), mp, rp

    y = conv3d.conv3d_same_na_tiled_plain(tx, mean, rstd, tw, "gelu")
    dw = conv3d.conv3d_wgrad_na_tiled_plain(tx, mean, rstd, tg, "gelu")
    monkeypatch.setattr(conv3d, "_na_padded", padded_everywhere)
    y_bad = conv3d.conv3d_same_na_tiled_plain(tx, mean, rstd, tw, "gelu")
    dw_bad = conv3d.conv3d_wgrad_na_tiled_plain(tx, mean, rstd, tg, "gelu")
    assert _rel(y_bad, y) > 100 * F32_TOL
    assert _rel(dw_bad, dw) > 100 * F32_TOL


# ------------------------------------------- bf16 parity with the Pallas

@pytest.mark.parametrize("C,F", [(8, 16), (24, 40)])
@pytest.mark.parametrize("act", ACTS)
def test_tiled_forward_matches_pallas_bf16(C, F, act):
    """The tiled model and ``conv3d_same_cw_na`` (interpret) in bf16, from
    the same statistics."""
    x, w, _ = _inputs(PALLAS_SHAPE, C, F, 7 * C + F)
    mean, rstd, stat = _stats(x)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    y = conv3d.conv3d_same_na_tiled_plain(tx, mean, rstd, tw, act)
    ref = from_cw(conv3d_same_cw_na(
        to_cw(jnp.asarray(tx.float().numpy(), jnp.bfloat16)), stat,
        jnp.asarray(_w_to_jax(tw.float().numpy()), jnp.bfloat16), act,
        interpret=True))
    assert ref.dtype == jnp.bfloat16
    assert _rel(y, torch.from_numpy(np.array(ref.astype(jnp.float32)))) \
        <= BF16_TOL


@pytest.mark.parametrize("C,F", [(8, 16), (24, 40)])
@pytest.mark.parametrize("act", ACTS)
def test_tiled_wgrad_matches_pallas_bf16(C, F, act):
    """The tiled model and ``conv3d_wgrad_cw2_na`` (interpret) in bf16,
    dW in fp32: the Pallas [3, 3, 3, C, F] against torch's [F, C, 3, 3,
    3]."""
    x, _, g = _inputs(PALLAS_SHAPE, C, F, 9 * C + F)
    mean, rstd, stat = _stats(x)
    tx, tg = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    dw = conv3d.conv3d_wgrad_na_tiled_plain(tx, mean, rstd, tg, act)
    ref = np.array(conv3d_wgrad_cw2_na(
        to_cw(jnp.asarray(tx.float().numpy(), jnp.bfloat16)), stat,
        to_cw(jnp.asarray(tg.float().numpy(), jnp.bfloat16)), act,
        interpret=True))
    assert ref.shape == (3, 3, 3, C, F)
    assert _rel(torch.from_numpy(_w_to_jax(dw.numpy())),
                torch.from_numpy(ref)) <= BF16_WGRAD_TOL


@pytest.mark.parametrize("act", ACTS)
def test_bf16_fused_op_on_the_cpu_matches_the_tiled_models(act):
    """``ConvInormAct3d`` in bf16 on the CPU (the plain versions) against
    the tiled models the card's kernels follow: its forward, and its dW
    from the statistics it computes."""
    C, F = 16, 8
    x, w, g = _inputs(SHAPE, C, F, 13)
    tx, tw, tg = (torch.from_numpy(v).bfloat16() for v in (x, w, g))
    tw.requires_grad_()
    y = conv3d.ConvInormAct3d.apply(tx, tw, EPS, act)
    y.backward(tg)
    mean, rstd = fused_norm.inorm_stats_plain(tx.reshape(2, -1, C), EPS)
    assert _rel(y.detach(), conv3d.conv3d_same_na_tiled_plain(
        tx, mean, rstd, tw.detach(), act)) <= BF16_TOL
    # dW rounds from fp32 to w's bf16 once
    assert _rel(tw.grad, conv3d.conv3d_wgrad_na_tiled_plain(
        tx, mean, rstd, tg, act)) <= BF16_TOL
