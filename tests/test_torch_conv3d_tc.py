"""The tensor-core route of the port's 3^3 conv, on the CPU.

``conv3d_route`` decides before any launch which kernel family a CUDA call
takes; the tensor-core forward reads the weights in the layout of
``pack_weights_tc`` and the tensor-core wgrad splits its voxel tiles by
``wgrad_tc_chunking``.  The kernels themselves run only on the card
(``chip_smoke.py`` phase 3 holds them against their plain versions); here
the packing, the chunking and the bf16 plain versions are held against the
JAX package's Pallas kernels and VJP in interpret mode.  Inputs come from
numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.ops.pallas.conv3d import conv3d_same as jax_conv3d_same
from cbim_tpu.ops.pallas.conv3d import conv3d_same_t as jax_conv3d_same_t
from cbim_tpu.ops.pallas.conv3d import conv3d_wgrad as jax_conv3d_wgrad
from cbim_tpu_torch.ops.kernels import conv3d
from test_torch_threads import few_torch_threads  # noqa: F401

#: (B, D, H, W) of the Pallas cases: its kernels tile D by 2 and H by 8
SHAPE = (2, 4, 8, 10)
#: a narrow width and the ragged one of chip_smoke.py's conv cases
WIDTHS = [(16, 8), (24, 40)]
#: bf16 outputs of fp32 sums rounded once on both sides: where the sums
#: straddle a rounding boundary they differ by one bf16 ulp, at most 2^-8
#: of max|ref|; a wrong tap, flip or channel errs by O(max|ref|)
BF16_TOL = 2 ** -7
#: dW in fp32 from bf16 inputs (exact products) summed over 640 voxels in
#: other orders
WGRAD_TOL = 1e-5


def _w_to_jax(w):
    """torch [F, C, 3, 3, 3] -> Flax/Pallas [3, 3, 3, C, F]."""
    return np.transpose(w, (2, 3, 4, 1, 0))


def _bf16_inputs(C, F, seed):
    """x, w, g as bf16 torch tensors and the same values as bf16 jax
    arrays (w in the Pallas layout)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(*SHAPE, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(F, C, 3, 3, 3))
                          / np.sqrt(27 * C)).astype(np.float32))
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
    (torch.bfloat16, 32, 32, conv3d.TENSOR_CORE),
    (torch.bfloat16, 96, 32, conv3d.TENSOR_CORE),
    (torch.bfloat16, 192, 64, conv3d.TENSOR_CORE),
    (torch.bfloat16, 128, 128, conv3d.TENSOR_CORE),
    (torch.bfloat16, 24, 40, conv3d.TENSOR_CORE),
    (torch.bfloat16, 8, 8, conv3d.TENSOR_CORE),
    (torch.float32, 32, 32, conv3d.TF32X3),
    (torch.float32, 96, 32, conv3d.TF32X3),
    (torch.float32, 20, 36, conv3d.CUDA_CORE),
    (torch.bfloat16, 12, 32, conv3d.CUDA_CORE),
    (torch.bfloat16, 32, 20, conv3d.CUDA_CORE),
    (torch.bfloat16, 20, 36, conv3d.CUDA_CORE),
    (torch.bfloat16, 1, 32, conv3d.CUDA_CORE),
])
def test_conv3d_route(dtype, C, F, route):
    assert conv3d.conv3d_route(dtype, C, F) == route
    # the dgrad (F -> C on flip-swapped weights) takes the forward's route
    assert conv3d.conv3d_route(dtype, F, C) == route


@pytest.mark.parametrize("dtype,C,F", [
    (torch.bfloat16, 16, 8), (torch.bfloat16, 24, 40),
    (torch.bfloat16, 20, 36), (torch.float32, 16, 8)])
def test_wrappers_launch_the_kernels_of_their_route(monkeypatch, dtype, C, F):
    """With the launches recorded in place of the card: conv3d_same,
    conv3d_dgrad and conv3d_wgrad launch the entries conv3d_route names
    (the dgrad with the forward's weights and the flip; in fp32 at widths
    of multiples of 8 the TF32 forwards and wgrad), and so does the fused
    norm-act pair: its tensor-core kernels in bf16 at widths of multiples
    of 8, in fp32 there the TF32 forward and wgrad, its CUDA-core ones
    otherwise."""
    calls = []

    def record(name):
        def launch(*args, **kw):
            calls.append((name, args[2] if len(args) > 2 else None,
                          kw.get("flip", False)))
            return torch.empty(0)
        return launch

    for fn in ("_launch_fwd", "_launch_fwd_tc", "_launch_fwd_tf32",
               "_launch_wgrad", "_launch_wgrad_tc", "_launch_wgrad_tf32"):
        monkeypatch.setattr(conv3d, fn, record(fn))
    monkeypatch.setattr(conv3d._backend, "uses_kernels", lambda t: True)
    x = torch.zeros(1, 2, 3, 4, C, dtype=dtype)
    g = torch.zeros(1, 2, 3, 4, F, dtype=dtype)
    w = torch.zeros(F, C, 3, 3, 3, dtype=dtype)
    stats = torch.zeros(1, C), torch.ones(1, C)
    conv3d.conv3d_same_cuda(x, w)
    conv3d.conv3d_dgrad_cuda(g, w)
    conv3d.conv3d_wgrad_cuda(x, g)
    conv3d.conv3d_same_na_cuda(x, *stats, w, "relu")
    conv3d.conv3d_wgrad_na_cuda(x, *stats, g, "relu")
    route = conv3d.conv3d_route(dtype, C, F)
    assert calls[:3] == {
        conv3d.TENSOR_CORE: [("_launch_fwd_tc", "conv3d_same_fwd_tc", False),
                             ("_launch_fwd_tc", "conv3d_dgrad_tc", True),
                             ("_launch_wgrad_tc", None, False)],
        conv3d.TF32X3: [("_launch_fwd_tf32", "conv3d_same_fwd_tf32", False),
                        ("_launch_fwd_tf32", "conv3d_dgrad_tf32", True),
                        ("_launch_wgrad_tf32", None, False)],
        conv3d.CUDA_CORE: [("_launch_fwd", "conv3d_same_fwd", False),
                           ("_launch_fwd", "conv3d_dgrad", False),
                           ("_launch_wgrad", None, False)]}[route]
    assert [c[0] for c in calls[3:]] == {
        conv3d.TENSOR_CORE: ["_launch_fwd_tc", "_launch_wgrad_tc"],
        conv3d.TF32X3: ["_launch_fwd_tf32", "_launch_wgrad_tf32"],
        conv3d.CUDA_CORE: ["_launch_fwd", "_launch_wgrad"]}[route]
    assert calls[3][1] == conv3d.FORWARD_KEYS[route][2]


#: the widths MedFormer-3D sends to the kernels (and the ragged 24 -> 40)
MEDFORMER_WIDTHS = [(32, 32), (64, 64), (96, 32), (192, 64), (128, 128),
                    (24, 40)]


def test_every_medformer_width_takes_the_tensor_core_route():
    """The widths MedFormer-3D sends to the kernels, forward and dgrad."""
    for C, F in MEDFORMER_WIDTHS:
        for c, f in ((C, F), (F, C)):
            assert conv3d.conv3d_route(torch.bfloat16, c, f) == \
                conv3d.TENSOR_CORE, (c, f)


def test_every_fp32_medformer_width_takes_the_tf32_route():
    """fp32 serving (AMOS-CT) and the fp32 step: every forward and dgrad
    width on the TF32 kernels, whose fused forward takes them too."""
    for C, F in MEDFORMER_WIDTHS:
        for c, f in ((C, F), (F, C)):
            route = conv3d.conv3d_route(torch.float32, c, f)
            assert route == conv3d.TF32X3, (c, f)
            assert conv3d.FORWARD_KEYS[route] == (
                "conv3d_same_fwd_tf32", "conv3d_dgrad_tf32",
                "conv3d_same_na_fwd_tf32")


@pytest.mark.parametrize("F,bn,n_tiles", [
    (8, 32, 1), (32, 32, 1), (40, 64, 1), (64, 64, 1), (96, 96, 1),
    (128, 128, 1), (160, 96, 2), (192, 96, 2)])
def test_tc_tile_n_covers_f_in_at_most_128_wide_tiles(F, bn, n_tiles):
    assert conv3d.tc_tile_n(F) == (bn, n_tiles)
    assert bn % 32 == 0 and bn <= conv3d.TC_MAX_BN and bn * n_tiles >= F
    assert bn * (n_tiles - 1) < F


# ---------------------------------------------------------------- packing

@pytest.mark.parametrize("C,F", [(16, 8), (24, 40), (40, 24), (8, 192)])
def test_packed_weights_layout(C, F):
    """[n_tiles, chunks, kd, kh, kw, 32, BN + 8], zeros past C, F and in
    the 8-value row padding; every weight at its place."""
    rng = np.random.default_rng(C * 7 + F)
    w = torch.from_numpy(rng.normal(size=(F, C, 3, 3, 3)).astype(np.float32))
    wp = conv3d.pack_weights_tc(w)
    bn, n_tiles = conv3d.tc_tile_n(F)
    n_chunks = -(-C // conv3d.TC_CHUNK)
    assert tuple(wp.shape) == (n_tiles, n_chunks, 3, 3, 3, 32, bn + 8)
    assert wp.is_contiguous() and wp.dtype == w.dtype
    assert float(wp[..., bn:].abs().max()) == 0.0
    f, c = F - 1, C - 1
    assert wp[f // bn, c // 32, 2, 0, 1, c % 32, f % bn] == w[f, c, 2, 0, 1]
    assert float(wp.abs().sum()) == pytest.approx(float(w.abs().sum()),
                                                  rel=1e-6)


@pytest.mark.parametrize("C,F", WIDTHS)
def test_packed_plain_conv_matches_plain_and_pallas(C, F):
    """A plain conv from the packed weights (the tensor-core kernel's
    arithmetic) equals ``conv3d_same_plain`` and the Pallas ``conv3d_same``
    in interpret mode, fp32."""
    rng = np.random.default_rng(C + 3 * F)
    x = rng.normal(size=(*SHAPE, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3, 3)) / np.sqrt(27 * C)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y = conv3d.conv3d_same_packed_plain(tx, conv3d.pack_weights_tc(tw), F)
    ref = jax_conv3d_same(jnp.asarray(x), jnp.asarray(_w_to_jax(w)),
                          interpret=True)
    # fp32 everywhere; 27 * C products summed in other orders
    torch.testing.assert_close(y, conv3d.conv3d_same_plain(tx, tw),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------ bf16 parity (plain)

@pytest.mark.parametrize("C,F", WIDTHS)
def test_bf16_conv3d_same_matches_pallas(C, F):
    (x, w, _), (jx, jw, _) = _bf16_inputs(C, F, C)
    y = conv3d.conv3d_same(x, w)
    assert y.dtype == torch.bfloat16 and y.shape == (*SHAPE, F)
    ref = jax_conv3d_same(jx, jw, interpret=True)
    _close(y, ref, BF16_TOL)
    _close(conv3d.conv3d_same_packed_plain(x, conv3d.pack_weights_tc(w), F),
           ref, BF16_TOL)


@pytest.mark.parametrize("C,F", WIDTHS)
def test_bf16_conv3d_dgrad_matches_pallas_vjp(C, F):
    """dx of the Pallas VJP (the forward kernel on flip-swapped weights)."""
    (_, w, g), (jx, jw, jg) = _bf16_inputs(C, F, C + 1)
    _, vjp = jax.vjp(jax_conv3d_same_t, jx, jw)
    dx_j, _ = vjp(jg)
    dx = conv3d.conv3d_dgrad(g, w)
    assert dx.dtype == torch.bfloat16 and dx.shape == (*SHAPE, C)
    _close(dx, dx_j, BF16_TOL)


@pytest.mark.parametrize("C,F", WIDTHS)
def test_bf16_conv3d_wgrad_matches_pallas(C, F):
    (x, _, g), (jx, _, jg) = _bf16_inputs(C, F, C + 2)
    dw = conv3d.conv3d_wgrad(x, g)
    assert dw.dtype == torch.float32 and dw.shape == (F, C, 3, 3, 3)
    ref = jax_conv3d_wgrad(jx, jg, interpret=True)
    _close(torch.from_numpy(_w_to_jax(dw.numpy())), ref, WGRAD_TOL)


@pytest.mark.parametrize("C,F", WIDTHS)
def test_bf16_conv3d_same_grads_match_pallas_vjp(C, F):
    """Conv3dSame's backward in bf16 against the Pallas VJP: dx, and dW,
    which both round from fp32 to w's bf16 once (one ulp, 2^-8 of max)."""
    (x, w, g), (jx, jw, jg) = _bf16_inputs(C, F, C + 3)
    _, vjp = jax.vjp(jax_conv3d_same_t, jx, jw)
    dx_j, dw_j = vjp(jg)
    tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
    conv3d.Conv3dSame.apply(tx, tw).backward(g)
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    _close(tx.grad, dx_j, BF16_TOL)
    _close(torch.from_numpy(_w_to_jax(tw.grad.float().numpy())), dw_j,
           BF16_TOL)


# --------------------------------------------------------------- chunking

@pytest.mark.parametrize("shape,C,F", [
    ((2, 128, 128, 128), 96, 32), ((2, 128, 128, 128), 32, 32),
    ((2, 64, 64, 64), 192, 64), ((2, 32, 32, 32), 128, 128),
    ((2, 17, 23, 30), 24, 40), ((1, 4, 8, 8), 8, 8),
    ((2, 64, 64, 64), 192, 192)])
def test_wgrad_tc_chunking_covers_every_voxel_within_the_cap(shape, C, F):
    n_tiles = conv3d.voxel_tiles(*shape)
    B, D, H, W = shape
    td, th, tw = conv3d.TC_VOXEL_TILE
    assert n_tiles * td * th * tw >= B * D * H * W
    assert n_tiles == B * -(-D // td) * -(-H // th) * -(-W // tw)
    per, n_chunks = conv3d.wgrad_tc_chunking(n_tiles, C, F,
                                             conv3d.TC_WGRAD_TILE)
    # every tile in exactly one chunk, no chunk empty
    assert per * n_chunks >= n_tiles > per * (n_chunks - 1)
    assert 1 <= n_chunks <= 65535
    assert n_chunks * 27 * C * F * 4 <= conv3d._WGRAD_MAX_PARTIAL_BYTES


def test_wgrad_tc_chunking_respects_the_partial_cap():
    """A dW so wide that one chunk's partials pass a tenth of the cap."""
    C = F = 1024
    per, n_chunks = conv3d.wgrad_tc_chunking(10 ** 6, C, F,
                                             conv3d.TC_WGRAD_TILE)
    assert n_chunks * 27 * C * F * 4 <= conv3d._WGRAD_MAX_PARTIAL_BYTES
    assert per * n_chunks >= 10 ** 6
