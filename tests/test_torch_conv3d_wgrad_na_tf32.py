"""The fused preact conv's fp32 weight gradient on the TF32 route
(3xTF32), on the CPU.

fp32 CUDA calls of ``conv3d_wgrad_na`` at widths of multiples of 8 launch
``conv3d_wgrad_na_tf32`` (``csrc/conv3d_wgrad_na_tf32.cu``): the kernel of
``conv3d_wgrad_tf32`` (``csrc/conv3d_wgrad_tf32.cuh``) whose split of each
staged x halo first normalises it, act((x - mean) * rstd) in fp32, then
three TF32 tensor-core products summed in fp32.  The kernel runs only on
the card (``chip_smoke.py`` phase 3 holds it against its plain version and
an fp64 weight gradient).  Here its arithmetic,
``conv3d_wgrad_na_tf32x3_plain``, is held against an fp64 weight gradient
of the normalised input and the JAX package's Pallas ``conv3d_wgrad_cw2_na``
in interpret mode for each act; the route and the wrapper's launch key are
checked with the launch recorded in place of the card.  Inputs come from
numpy with a seed, with a clearly nonzero mean, so that a padding
normalised to act(-mean * rstd) instead of 0 fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.ops.pallas.conv3d import conv3d_wgrad_cw2_na, to_cw
from cbim_tpu_torch.ops.kernels import conv3d, fused_norm
from test_torch_threads import few_torch_threads  # noqa: F401

#: (B, D, H, W): the Pallas kernel tiles D by 2 and H by 8; the TF32
#: wgrad's (4, 8, 8) voxel tiles do not divide W
SHAPE = (2, 4, 8, 10)
EPS = 1e-4
ACTS = [None, "relu", "gelu"]
#: 3xTF32 against fp64, held against max|dW| (as the unfused TF32 wgrad's
#: tests): the dropped lo x lo products and the lo parts' rounding cost at
#: most 3 * 2^-22 of each product; one TF32 pass errs by 2^-11
TF32X3_TOL = 1e-5
#: against the Pallas kernel (fp32 sums over 1280 voxels in another order,
#: and its GELU's erf polynomial), as ``test_torch_conv_na.py``
PALLAS_TOL = 2e-4


def _inputs(C, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=1.5, size=(*SHAPE, C)).astype(np.float32)
    g = rng.normal(size=(*SHAPE, F)).astype(np.float32)
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(1, 2, 3)).astype(np.float32)
    rstd = (1.0 / np.sqrt(x64.var(axis=(1, 2, 3)) + EPS)).astype(np.float32)
    return x, g, mean, rstd


def _rel(got, ref):
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float((got - ref).abs().max() / ref.abs().max())


def _normed64(x, mean, rstd, act):
    """act((x - mean) * rstd) in fp64 from the fp32 statistics."""
    n = (x.double() - mean.double()[:, None, None, None]) \
        * rstd.double()[:, None, None, None]
    if act == "relu":
        return n.clamp_min(0)
    if act == "gelu":
        return torch.nn.functional.gelu(n)
    return n


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("C,F", [(8, 24), (24, 40)])
def test_wgrad_na_tf32x3_plain_matches_fp64_and_pallas(C, F, act):
    """fp32 accuracy: within TF32X3_TOL of max|dW| of an fp64 weight
    gradient of the fp64 norm-act (zero padding of the normalised input),
    and within PALLAS_TOL of ``conv3d_wgrad_cw2_na`` in interpret mode."""
    x, g, mean, rstd = _inputs(C, F, 11 * C + F)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    tm, tr = torch.from_numpy(mean), torch.from_numpy(rstd)
    dw = conv3d.conv3d_wgrad_na_tf32x3_plain(tx, tm, tr, tg, act)
    assert dw.dtype == torch.float32 and dw.shape == (F, C, 3, 3, 3)
    ref64 = torch.nn.grad.conv3d_weight(
        _normed64(tx, tm, tr, act).permute(0, 4, 1, 2, 3),
        (F, C, 3, 3, 3), tg.double().permute(0, 4, 1, 2, 3), padding=1)
    assert _rel(dw, ref64) <= TF32X3_TOL
    stat = jnp.asarray(np.stack([mean, rstd], axis=1)[..., None])
    ref = np.asarray(conv3d_wgrad_cw2_na(to_cw(jnp.asarray(x)), stat,
                                         to_cw(jnp.asarray(g)), act,
                                         interpret=True))
    assert _rel(dw.permute(2, 3, 4, 1, 0), ref) <= PALLAS_TOL
    # the unfused pair of the TF32 route (inorm_apply, then the TF32 wgrad)
    # computes the same thing
    xn = fused_norm.inorm_apply_plain(tx.reshape(SHAPE[0], -1, C), tm, tr,
                                      act).view(tx.shape)
    torch.testing.assert_close(dw, conv3d.conv3d_wgrad_tf32x3_plain(xn, tg),
                               rtol=0, atol=0)


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_single_tf32_pass_of_the_normalised_input_fails(act):
    """The tolerance sees the split: one TF32 product of the normalised x
    and g errs by more than 10x TF32X3_TOL."""
    C, F = 8, 24
    x, g, mean, rstd = _inputs(C, F, 5)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    tm, tr = torch.from_numpy(mean), torch.from_numpy(rstd)
    xn = conv3d._normed(tx, tm, tr, act)
    ref64 = torch.nn.grad.conv3d_weight(
        _normed64(tx, tm, tr, act).permute(0, 4, 1, 2, 3),
        (F, C, 3, 3, 3), tg.double().permute(0, 4, 1, 2, 3), padding=1)
    one = conv3d.conv3d_wgrad_plain(conv3d.tf32_round(xn),
                                    conv3d.tf32_round(tg))
    assert _rel(one, ref64) > 10 * TF32X3_TOL


@pytest.mark.parametrize("dtype,C,F,key", [
    (torch.float32, 8, 24, "conv3d_wgrad_na_tf32"),
    (torch.float32, 96, 32, "conv3d_wgrad_na_tf32"),
    (torch.float32, 20, 36, "conv3d_wgrad_na"),
    (torch.float32, 8, 12, "conv3d_wgrad_na"),
    (torch.bfloat16, 8, 24, "conv3d_wgrad_na_tc"),
    (torch.bfloat16, 20, 36, "conv3d_wgrad_na")])
def test_route_picks_the_launch_key(monkeypatch, dtype, C, F, key):
    """With ``_build.call`` recorded in place of the card: conv3d_wgrad_na
    follows ``conv3d_route`` to one C entry, counted under its own key; at
    fp32 widths of multiples of 8 that is ``conv3d_wgrad_na_tf32`` with x,
    g, the statistics, scratch of n_chunks * 27 * C * F fp32 partials, the
    act code, the shape and ``wgrad_tc_chunking`` at the TF32 tile."""
    calls = []
    monkeypatch.setattr(conv3d._build, "call",
                        lambda name, *args, device: calls.append(
                            (name, args)))
    monkeypatch.setattr(conv3d._backend, "uses_kernels", lambda t: True)
    shape = (1, 2, 3, 4)
    x = torch.zeros(*shape, C, dtype=dtype)
    g = torch.zeros(*shape, F, dtype=dtype)
    mean, rstd = torch.zeros(1, C), torch.ones(1, C)
    before = dict(conv3d.launches)
    dw = conv3d.conv3d_wgrad_na_cuda(x, mean, rstd, g, "gelu")
    (name, args), = calls
    assert name == key
    moved = {k: conv3d.launches[k] - before[k] for k in before
             if conv3d.launches[k] != before[k]}
    assert moved == {key: 1}
    assert dw.shape == (F, C, 3, 3, 3) and dw.dtype == torch.float32
    route = conv3d.conv3d_route(dtype, C, F)
    assert (route == conv3d.TF32X3) == (key == "conv3d_wgrad_na_tf32")
    if key == "conv3d_wgrad_na_tf32":
        per, n_chunks = conv3d.wgrad_tc_chunking(
            conv3d.voxel_tiles(*shape), C, F, conv3d.TF32_WGRAD_TILE)
        # (x, g, mean, rstd, partial, dw, act, B, D, H, W, C, F,
        #  tiles_per_chunk, n_chunks)
        assert args[:4] == (x.data_ptr(), g.data_ptr(), mean.data_ptr(),
                            rstd.data_ptr())
        assert args[5] == dw.data_ptr()
        assert args[6] == fused_norm._act_code("gelu")
        assert args[7:] == (*shape, C, F, per, n_chunks)


def test_bf16_and_ragged_widths_keep_their_kernels():
    """The TF32 route is fp32 only: bf16 at widths of multiples of 8 stays
    on the tensor-core pair, any dtype at other widths on the CUDA cores."""
    assert conv3d.conv3d_route(torch.float32, 32, 32) == conv3d.TF32X3
    assert conv3d.conv3d_route(torch.bfloat16, 32, 32) == conv3d.TENSOR_CORE
    assert conv3d.conv3d_route(torch.float32, 20, 36) == conv3d.CUDA_CORE
