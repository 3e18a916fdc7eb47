"""The window attention's tensor-core arithmetic, on the CPU.

CUDA calls of ``window_attention`` launch ``csrc/window_attention.cu``: in
fp32 3xTF32 (q, k, v and the softmax weights P each split into TF32 hi and
lo parts, three products summed in fp32), in bf16 the stored values with P
rounded to bf16; both run an online softmax in base 2 over chunks of 32
keys, each chunk's P V summed apart.  The kernel runs only on the card
(``chip_smoke.py`` phase 3 holds it against its plain version, and in fp32
its error against an fp64 evaluation against SDPA's).  Here its arithmetic,
``window_attention_tf32x3_plain`` and ``window_attention_bf16_plain``, is
held against the JAX package's ``fused_window_attention`` in interpret mode
and ``reference_window_attention``, and against an fp64 evaluation; and the
wrapper's refusal of views and windows the kernel cannot take is checked
with the launch recorded in place of the card.  Inputs come from numpy
with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbim_tpu.ops.pallas.window_attention import (fused_window_attention,
                                                  reference_window_attention)
from cbim_tpu_torch.ops.kernels import conv3d
from cbim_tpu_torch.ops.kernels import window_attention as wa
from test_torch_threads import few_torch_threads  # noqa: F401

#: (B, H, N, D): 2D Swin's 7x7 windows, nnFormer's 4^3 and the 3D 7^3
#: window, each at both head dims (two windows each, nW = 2)
CASES = [(2, 2, 49, 16), (2, 2, 49, 32), (2, 2, 64, 16), (2, 2, 64, 32),
         (2, 3, 343, 16), (2, 2, 343, 32)]
#: tolerances, of max|o|:
#: - the fp32 model against fp64: 3xTF32's dropped lo x lo products and lo
#:   roundings (at most 3 * 2^-22 of each product) and fp32 sums; fp32
#:   itself errs by about 1e-6 here.  A single TF32 pass errs by 2^-11.
#: - the fp32 model against the JAX kernel and reference (fp32 sums and
#:   exponentials in another order and base): ``tests/test_pallas.py``'s
#:   2e-5.
#: - bf16: P rounded to bf16 (2^-9 of each weight) and the output rounded
#:   once: within phase 3's 2^-6 of max|o|; against the JAX bf16 kernel,
#:   which also takes bf16 inputs and rounds its output, the JAX test's
#:   2e-2.
F64_TOL = 4e-6
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_PLAIN_TOL = 2 ** -6


def _inputs(B, H, N, D, seed, nW=2):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, N, D)).astype(np.float32)
               for _ in range(3))
    rel_bias = rng.normal(size=(H, N, N)).astype(np.float32)
    region = rng.integers(0, 4, size=(nW, N)).astype(np.int32)
    return q, k, v, rel_bias, region


def _dense_bias(rel_bias, region, B):
    """The TPU kernel's (B, H, N, N) bias: rel_bias plus the -100 mask of
    window b % nW (window_partition is batch-major)."""
    if region is None:
        return rel_bias[None].astype(np.float32)
    nW = region.shape[0]
    mask = np.where(region[:, :, None] != region[:, None, :], -100.0, 0.0)
    return (rel_bias[None] + mask[np.arange(B) % nW][:, None]).astype(
        np.float32)


def _fp64(q, k, v, rel_bias, region):
    """o in fp64: softmax(q k^T D^-1/2 + bias) v."""
    D = q.shape[-1]
    s = np.einsum("bhnd,bhmd->bhnm", q.astype(np.float64) * D ** -0.5,
                  k.astype(np.float64))
    s = s + _dense_bias(rel_bias, region, q.shape[0]).astype(np.float64)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhnm,bhmd->bhnd", p, v.astype(np.float64))


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,H,N,D", CASES)
def test_tf32x3_model_matches_fp64_pallas_and_reference(B, H, N, D, masked):
    q, k, v, rel_bias, region = _inputs(B, H, N, D, seed=N + D)
    region = region if masked else None
    t = [torch.from_numpy(a) for a in (q, k, v, rel_bias)]
    out = wa.window_attention_tf32x3_plain(
        *t, None if region is None else torch.from_numpy(region))
    assert out.dtype == torch.float32 and out.shape == (B, H, N, D)
    assert _rel(out.numpy(), _fp64(q, k, v, rel_bias, region)) <= F64_TOL
    bias = jnp.asarray(_dense_bias(rel_bias, region, B))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for ref in (fused_window_attention(jq, jk, jv, bias, interpret=True),
                reference_window_attention(jq, jk, jv, bias)):
        assert _rel(out.numpy(), np.asarray(ref)) <= TOL["float32"]


def test_single_tf32_pass_fails_the_fp64_tolerance():
    """The tolerance sees the split: with q, k, v rounded to TF32 once (one
    pass of each product) the error is over 10x F64_TOL."""
    B, H, N, D = CASES[4]
    q, k, v, rel_bias, region = _inputs(B, H, N, D, seed=3)
    rounded = [conv3d.tf32_round(torch.from_numpy(a)) for a in (q, k, v)]
    out = wa.window_attention_plain(*rounded, torch.from_numpy(rel_bias),
                                    torch.from_numpy(region))
    assert _rel(out.numpy(), _fp64(q, k, v, rel_bias, region)) > 10 * F64_TOL


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,H,N,D", CASES)
def test_bf16_model_matches_the_plain_version_and_pallas(B, H, N, D, masked):
    """bf16 inputs: the model with P rounded to bf16 within 2^-6 of max|o|
    of the plain version (fp32 P), and within the JAX test's tolerance of
    the Pallas kernel on the same bf16 inputs."""
    q, k, v, rel_bias, region = _inputs(B, H, N, D, seed=2 * N + D)
    region = region if masked else None
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    treg = None if region is None else torch.from_numpy(region)
    out = wa.window_attention_bf16_plain(tq, tk, tv,
                                         torch.from_numpy(rel_bias), treg)
    assert out.dtype == torch.bfloat16
    plain = wa.window_attention_plain(tq, tk, tv, torch.from_numpy(rel_bias),
                                      treg)
    assert _rel(out.float().numpy(), plain.float().numpy()) <= BF16_PLAIN_TOL
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (tq, tk, tv))
    ref = fused_window_attention(jq, jk, jv,
                                 jnp.asarray(_dense_bias(rel_bias, region, B)),
                                 interpret=True)
    assert _rel(out.float().numpy(), np.asarray(ref.astype(jnp.float32))) \
        <= TOL["bfloat16"]


def test_key_order_and_chunks_do_not_change_the_sum():
    """The kernel's key order within a k8 step (slot t: key 2t, slot t + 4:
    key 2t + 1) is a permutation of each 8, tails left in place; and a
    chunked online softmax equals the one-shot softmax in fp64."""
    keys = torch.arange(19.0).view(1, 1, 19, 1)
    got = wa._key_pairs(keys).flatten().tolist()
    assert got == [0, 2, 4, 6, 1, 3, 5, 7, 8, 10, 12, 14, 9, 11, 13, 15,
                   16, 17, 18]
    rng = np.random.default_rng(0)
    s2 = torch.from_numpy(rng.normal(size=(1, 1, 5, 70)))
    v = torch.from_numpy(rng.normal(size=(1, 1, 70, 3)))
    got = wa._online_softmax_pv(s2.float(), (v.float(),),
                                lambda p, parts: p @ parts[0])
    p = torch.exp2(s2 - s2.amax(-1, keepdim=True))
    want = (p / p.sum(-1, keepdim=True)) @ v
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)


def test_base2_bias_pads_keys_and_rows():
    rel_bias = torch.randn(3, 49, 49)
    b2 = wa.base2_bias(rel_bias)
    assert b2.shape == (3, 64, 64) and b2.dtype == torch.float32
    torch.testing.assert_close(b2[:, :49, :49], rel_bias * wa.LOG2E)
    assert torch.isneginf(b2[:, :, 49:]).all()
    assert (b2[:, 49:, :49] == 0).all()
    assert wa.padded_keys(343) == 352 and wa.padded_keys(64) == 64


def _kernel_path(monkeypatch):
    """Where the wrapper would launch (``uses_kernels`` patched true, so
    this runs without a card): the launch is recorded, the plain versions
    are gone."""
    calls = []
    monkeypatch.setattr(wa._backend, "uses_kernels", lambda t: True)
    monkeypatch.setattr(wa, "window_attention_plain", None)
    monkeypatch.setattr(wa._build, "call",
                        lambda name, *args, device: calls.append(
                            (name, args)))
    return calls


def test_packed_qkv_views_launch_with_the_padded_bias(monkeypatch):
    """SwinUNETR's views of one packed (B, N, 3, H, D) tensor launch once,
    with Np, the views' strides and rel_bias at its own strides (the entry
    writes the base-2 padded bias into scratch first); the output is laid
    out (B, N, H, D)."""
    calls = _kernel_path(monkeypatch)
    B, H, N, D = 4, 3, 343, 16
    qkv = torch.zeros(B, N, 3, H, D)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    region = torch.zeros(2, N, dtype=torch.int32)
    # a permuted view, as SwinUNETR gathers it from its table
    rel_bias = torch.zeros(N, N, H).permute(2, 0, 1)
    before = wa.launches["window_attention"]
    with torch.no_grad():
        o = wa.window_attention_cuda(q, k, v, rel_bias, region)
    (name, args), = calls
    assert name == "window_attention"
    assert wa.launches["window_attention"] == before + 1
    # q, k, v, rel_bias, region, bias2, o, dtype, B, H, N, Np, D, nW,
    # split_on_load, sb, sh, sn, rsh, rsi, rsj, osb, osh, osn
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        rel_bias.data_ptr(), region.data_ptr())
    assert args[6] == o.data_ptr()
    assert args[7:15] == (0, B, H, N, 352, D, 2, 0)
    assert args[15:18] == q.stride()[:3] == (N * 3 * H * D, D, 3 * H * D)
    assert args[18:21] == rel_bias.stride()
    assert o.shape == (B, H, N, D) and o.transpose(1, 2).is_contiguous()
    assert args[21:] == o.stride()[:3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_refuses_views_it_cannot_stage(monkeypatch, dtype):
    """The kernel stages rows with 16-byte copies: a row stride that is no
    16-byte multiple, a base off 16 bytes, or q, k, v of different strides
    raise in the op's CUDA implementation (the checks read the views'
    memory, so the wrapper, which tracing runs, cannot make them), and
    nothing is launched."""
    calls = _kernel_path(monkeypatch)
    B, H, N, D = 2, 3, 49, 16
    bias = torch.zeros(H, N, N)
    with torch.no_grad():
        # rows 3 H D + 1 values apart
        qkv = torch.zeros(B, N, 3 * H * D + 1, dtype=dtype)[..., :3 * H * D]
        q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].view(B, N, H, D)
                   .transpose(1, 2) for i in range(3))
        with pytest.raises(ValueError, match="16-byte"):
            wa.window_attention_cuda(q, k, v, bias)
        # a base one value past 16-byte alignment
        flat = torch.zeros(B * H * N * D + 1, dtype=dtype)[1:]
        q = flat.view(B, H, N, D)
        with pytest.raises(ValueError, match="16-byte"):
            wa.window_attention_cuda(q, q, q, bias)
        q = torch.zeros(B, H, N, D, dtype=dtype)
        with pytest.raises(ValueError, match="one set of strides"):
            wa.window_attention_cuda(q, q.transpose(0, 1).contiguous()
                                .transpose(0, 1), q, bias)
    assert calls == []


def test_wrapper_refuses_windows_past_shared_memory(monkeypatch):
    """fp32 stages TF32 hi and lo planes of K and V where they fit the
    block's 227 KB; N = 512 at D = 32 needs 264 KB of them, so the op's
    CUDA implementation routes it to the split-on-load staging (fp32 values, 130 KB), and every
    window that fits today keeps the planes (N <= 448 at D = 32, bf16
    always).  A window past 227 KB even as values (N = 1000 at D = 32)
    still raises, and nothing is launched for it."""
    calls = _kernel_path(monkeypatch)
    N = 512
    assert wa.kernel_smem_bytes(N, 32, torch.float32, False) > wa._MAX_SMEM
    assert wa.tf32_split_on_load(N, 32, torch.float32)
    assert wa.kernel_smem_bytes(N, 32, torch.float32) == 2 * 512 * 32 * 4 \
        + 4 * 512 <= wa._MAX_SMEM
    for n, d in ((343, 32), (448, 32), (343, 16), (512, 16)):
        assert not wa.tf32_split_on_load(n, d, torch.float32), (n, d)
    for n in (343, 512):
        assert not wa.tf32_split_on_load(n, 32, torch.bfloat16)
    assert wa.kernel_smem_bytes(N, 32, torch.bfloat16) <= wa._MAX_SMEM
    bias = torch.zeros(1, N, N)
    with torch.no_grad():
        q = torch.zeros(1, 1, N, 32)
        wa.window_attention_cuda(q, q, q, bias)
        wa.window_attention_cuda(q.bfloat16(), q.bfloat16(), q.bfloat16(), bias)
        q16 = torch.zeros(1, 1, N, 16)
        wa.window_attention_cuda(q16, q16, q16, bias)
        big = torch.zeros(1, 1, 1000, 32)
        with pytest.raises(ValueError, match="shared memory"):
            wa.window_attention_cuda(big, big, big, torch.zeros(1, 1000, 1000))
    assert [c[0] for c in calls] == ["window_attention"] * 3
    # the split_on_load argument of each launch: fp32 D = 32 only
    assert [c[1][14] for c in calls] == [1, 0, 0]


@pytest.mark.parametrize("masked", [False, True])
def test_tf32x3_model_at_the_split_on_load_shape(masked):
    """N = 512 at D = 32 (nnFormer's stage 2, the split-on-load staging):
    the kernel's arithmetic, ``window_attention_tf32x3_plain``, agrees with
    fp64, the plain version and the JAX package's reference; the staging
    changes where hi and lo are made, not their values, so the same model
    holds."""
    B, H, N, D = 2, 2, 512, 32
    q, k, v, rel_bias, region = _inputs(B, H, N, D, seed=11)
    region = region if masked else None
    t = [torch.from_numpy(a) for a in (q, k, v, rel_bias)]
    treg = None if region is None else torch.from_numpy(region)
    out = wa.window_attention_tf32x3_plain(*t, treg)
    assert _rel(out.numpy(), _fp64(q, k, v, rel_bias, region)) <= F64_TOL
    plain = wa.window_attention_plain(*t, treg)
    assert _rel(out.numpy(), plain.numpy()) <= TOL["float32"]
    ref = reference_window_attention(
        *map(jnp.asarray, (q, k, v)),
        jnp.asarray(_dense_bias(rel_bias, region, B)))
    assert _rel(out.numpy(), np.asarray(ref)) <= TOL["float32"]
