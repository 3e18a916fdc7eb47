"""The port's probes (``cbim_tpu_torch/ops/kernels/probes.py`` and the
entry points of ``cbim_tpu_torch/tools``) against the JAX package's TPU
probes in ``tools/``, on the CPU.

On the CPU each probe wrapper runs its plain version: the copy-scale
``x * 2``, the dots an fp32 einsum cast to bf16, the ladder's ``full`` rung
``F.conv3d`` in fp32.  Those are held against the TPU probes' own
functions: the ladder against ``tools/probe_cw_dissect.build(x, w,
"full")`` run through Pallas in TPU interpret mode (NDHCW <-> NDHWC
transposes on the test side only), the dots against ``jax.lax.dot_general``
with ``tools/probe_lhst_dot.py``'s dimension numbers and ``jnp.dot`` (its
kernels are closures built at full size), the copy-scale against
``x * jnp.bfloat16(2.0)``.  Inputs come from numpy with a seed.  The
kernels themselves run on the card only (``chip_smoke.py`` phase 10).
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cbim_tpu_torch.ops.kernels import (launch_counts, probes,
                                        reset_launch_counts)
from cbim_tpu_torch.tools import bound_ms
from cbim_tpu_torch.tools import probe_bandwidth as pb
from cbim_tpu_torch.tools import probe_conv_dissect as pc
from cbim_tpu_torch.tools import probe_lhst_dot as pd
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tpu_probe(name):
    """A module of the JAX package's ``tools/`` (not a package), by path."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(a):
    """numpy fp32 -> (torch bf16, jax bf16) holding the same values."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


#: the ladder's tolerance against the TPU probe, of max|ref|: fp32, both
#: sum 27 C products in fp32 in other orders; bf16, both sum in fp32 and
#: round once to bf16, one ulp (2^-8 relative) apart at most
LADDER_TOL = {"float32": 2e-5, "bfloat16": 2 ** -8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ladder_full_rung_matches_the_tpu_probe(dtype):
    """The ladder's ``full`` rung (plain version on the CPU) against the
    TPU probe's ``build(x, w, "full")``, the production cw kernel's math,
    on (1, 4, 8, 16) with C = F = 8."""
    B, D, H, W, C, F = 1, 4, 8, 16, 8, 8
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(F, C, 3, 3, 3)) / math.sqrt(27 * C)).astype(
        np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    jx = jnp.asarray(tx.float().numpy()).astype(jdt).transpose(0, 1, 2, 4, 3)
    jw = jnp.asarray(tw.float().numpy()).astype(jdt).transpose(2, 3, 4, 1, 0)
    dissect = _tpu_probe("probe_cw_dissect")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(dissect.build(jx, jw, "full").astype(jnp.float32))
    ref = ref.transpose(0, 1, 2, 4, 3)                   # NDHFW -> NDHWF
    got = probes.conv3d_same_fwd_ladder(tx, tw, "full")
    assert got.dtype == tdt and got.shape == (B, D, H, W, F)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= LADDER_TOL[dtype] * np.abs(ref).max(), err


def test_dot_t_plain_matches_dot_general_dim0_by_dim0():
    """``probe_dot_t``'s plain version against ``jax.lax.dot_general`` with
    the TPU probe's dimension numbers (((0,), (0,)), ((), ())) and fp32
    accumulation, per tile; bf16 outputs within 2^-8 of max|ref|."""
    T, K, N, L = 3, 32, 24, 40
    rng = np.random.default_rng(1)
    ta, ja = _bf16(rng.normal(size=(T, K, L)).astype(np.float32))
    tw, jw = _bf16((rng.normal(size=(K, N)) / math.sqrt(K)).astype(
        np.float32))
    ref = jnp.stack([jax.lax.dot_general(
        jw, ja[t], (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        for t in range(T)])
    ref = np.asarray(ref.astype(jnp.float32))
    got = probes.dot_t(ta, tw)
    assert got.dtype == torch.bfloat16 and got.shape == (T, N, L)
    assert np.abs(got.float().numpy() - ref).max() <= \
        2 ** -8 * np.abs(ref).max()
    assert torch.equal(probes.dot_t(ta, tw, stationary=False), got)


def test_gemm_plain_matches_jnp_dot():
    """``probe_gemm``'s plain version against ``big_square``'s
    ``jnp.dot(a[t], b, preferred_element_type=f32)`` cast to bf16; within
    2^-8 of max|ref|."""
    T, M, K, N = 2, 32, 48, 40
    rng = np.random.default_rng(2)
    ta, ja = _bf16(rng.normal(size=(T, M, K)).astype(np.float32))
    tb, jb = _bf16((rng.normal(size=(K, N)) / math.sqrt(K)).astype(
        np.float32))
    ref = np.asarray(jnp.stack([
        jnp.dot(ja[t], jb, preferred_element_type=jnp.float32)
        .astype(jnp.bfloat16) for t in range(T)]).astype(jnp.float32))
    got = probes.gemm(ta, tb)
    assert got.dtype == torch.bfloat16 and got.shape == (T, M, N)
    assert np.abs(got.float().numpy() - ref).max() <= \
        2 ** -8 * np.abs(ref).max()


def test_copy_scale_plain_matches_the_tpu_probe_exactly():
    """y = 2x is exact in bf16 on both sides (``scale_kernel``'s
    ``x * jnp.bfloat16(2.0)``)."""
    tx, jx = _bf16(np.random.default_rng(3).normal(size=(2, 64, 32))
                   .astype(np.float32) * 100)
    ref = np.asarray((jx * jnp.bfloat16(2.0)).astype(jnp.float32))
    for vec in (True, False):
        for block in probes.COPY_BLOCKS:
            got = probes.copy_scale(tx, vec, block)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), ref)


def test_cpu_calls_leave_the_probe_counters_untouched():
    reset_launch_counts()
    x = torch.randn(4, 8).to(torch.bfloat16)
    probes.copy_scale(x)
    probes.dot_t(torch.randn(2, 8, 16).bfloat16(),
                 torch.randn(8, 4).bfloat16())
    probes.gemm(torch.randn(2, 8, 16).bfloat16(),
                torch.randn(16, 4).bfloat16())
    probes.conv3d_same_fwd_ladder(torch.randn(1, 2, 3, 4, 8),
                                  torch.randn(4, 8, 3, 3, 3))
    counts = launch_counts()
    assert {k: counts[k] for k in probes.launches} == dict.fromkeys(
        probes.launches, 0)


def test_copy_scale_refuses_what_its_16_byte_path_cannot_take():
    """No quiet fall back to the 2-byte path: a misaligned buffer or a
    length that is not a multiple of 8 raises, as do a block size the
    kernel has not and a dtype other than bf16."""
    flat = torch.zeros(64, dtype=torch.bfloat16)
    for bad in (flat[1:], flat[:-1]):
        with pytest.raises(ValueError, match="16-byte"):
            probes.copy_scale(bad, vec=True)
        probes.copy_scale(bad, vec=False)
    with pytest.raises(ValueError, match="block"):
        probes.copy_scale(flat, block=4096)
    with pytest.raises(ValueError, match="bf16"):
        probes.copy_scale(flat.float())


def test_ladder_cut_rungs_run_on_the_card_only():
    x, w = torch.randn(1, 2, 3, 4, 8), torch.randn(4, 8, 3, 3, 3)
    for phase in ("load", "stage", "fma"):
        with pytest.raises(ValueError, match="card"):
            probes.conv3d_same_fwd_ladder(x, w, phase)
    with pytest.raises(ValueError, match="phase"):
        probes.conv3d_same_fwd_ladder(x, w, "dma")
    with pytest.raises(ValueError, match="bn"):
        probes.conv3d_same_fwd_ladder(x, w, "full", bn=48)
    assert probes.production_bn(32) == 32 and probes.production_bn(40) == 64


@pytest.mark.parametrize("mod", [pb, pd, pc])
def test_probe_entry_points_need_a_card(mod):
    """A probe measures the card: on the CPU it raises, it does not time
    the plain versions; an unknown case is refused."""
    with pytest.raises(RuntimeError):
        mod.run("cpu")
    with pytest.raises(SystemExit):
        mod.main(["no_such_case"])


@pytest.mark.parametrize("work,dtype,want_ms,by", [
    (lambda: (pb.B * pb.S * pb.C, pb.nbytes()), "bfloat16", 0.160, "bytes"),
    (pd.dot_work, "bfloat16", 1.202, "bytes"),
    (pd.square_work, "bfloat16", 0.139, "operations"),
    (lambda: (pc.flops(pc.SHAPES["bf16_32"][0]), 0), "bfloat16", 0.234,
     "operations"),
    (lambda: (pc.flops(pc.SHAPES["bf16_96"][0]), 0), "bfloat16", 0.703,
     "operations"),
    (lambda: (pc.flops(pc.SHAPES["fp32_96"][0]), 0), "float32", 10.385,
     "operations")])
def test_probe_bounds_from_their_shapes(work, dtype, want_ms, by):
    """The least time the card could take for each probe's work at its
    full size: the larger of bytes over 3.35 TB/s and FLOPs over the
    dtype's peak (989 TFLOP/s bf16, 67 fp32)."""
    ms, what = bound_ms(*work(), dtype)
    assert what == by and ms == pytest.approx(want_ms, abs=1e-3)
