#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cbim_tpu_torch``) on one NVIDIA H100.

Phases, each printing its result; any failure raises and exits non-zero:

1. device: a CUDA card of compute capability 9.0; its name and power limit
   as ``nvidia-smi`` reports them;
2. build: the CUDA kernels from ``cbim_tpu_torch/csrc`` (one nvcc per
   source, all started together; sm_90a);
3. kernels vs their plain PyTorch versions on the card, at the serving and
   training paths' shapes, fp32 and bf16, forward and backward: max error
   against stated tolerances, and each kernel's time beside its plain
   version's;
4. a small MedFormer-3D on a 64^3 input, same seeded weights, on the card
   (kernels) and on the CPU (plain versions): softmax outputs compared;
4b. one train step of that small model, card vs CPU, fp32 with TF32 off:
   the loss and every parameter's gradient compared;
5. serving: the full-width AMOS-CT MedFormer-3D with seeded random weights
   serves two synthetic NIfTI requests through
   ``cbim_tpu_torch.prediction.main``; every forward kernel must have
   launched;
6. training: the flagship recipe (``bench.py``: full-width MedFormer-3D,
   GELU, 128^3 crops, batch 2, bf16 autocast, remat of every stage, AdamW,
   EMA) trains a few steps on the synthetic corpus through
   ``cbim_tpu_torch.train.main``; every kernel, backward ones included,
   must have launched, and every loss must be finite.  Launch counts
   include the forward that remat recomputes in the backward pass.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

#: TPU kernels each CUDA kernel replaces (file:line of the function that
#: reaches pl.pallas_call)
KERNELS = {
    "inorm_stats": ("cbim_tpu_torch/csrc/fused_norm.cu",
                    "cbim_tpu/ops/pallas/fused_norm.py:223"),
    "inorm_apply": ("cbim_tpu_torch/csrc/fused_norm.cu",
                    "cbim_tpu/ops/pallas/fused_norm.py:241"),
    "conv3d_same_fwd": ("cbim_tpu_torch/csrc/conv3d.cu",
                        "cbim_tpu/ops/pallas/conv3d.py:299"),
    "conv3d_wgrad": ("cbim_tpu_torch/csrc/conv3d.cu",
                     "cbim_tpu/ops/pallas/conv3d.py:582"),
    "inorm_bwd_stats": ("cbim_tpu_torch/csrc/fused_norm.cu",
                        "cbim_tpu/ops/pallas/fused_norm.py:257"),
    "inorm_bwd_apply": ("cbim_tpu_torch/csrc/fused_norm.cu",
                        "cbim_tpu/ops/pallas/fused_norm.py:257"),
}
#: the forward kernels, which serving launches
FORWARD_KERNELS = ("inorm_stats", "inorm_apply", "conv3d_same_fwd")

#: 3^3 conv shapes of the serving path (B, D, H, W, C, F): inc/up4 at
#: 128^3, down1/up3 at 64^3, down2/up2 at 32^3, plus a ragged shape
CONV_CASES = [(2, 128, 128, 128, 32, 32), (2, 128, 128, 128, 96, 32),
              (2, 64, 64, 64, 64, 64), (2, 64, 64, 64, 192, 64),
              (2, 32, 32, 32, 128, 128), (2, 17, 23, 30, 24, 40)]
#: the conv case whose times go into the JSON record (up4's widest conv);
#: its dgrad (the forward kernel on flip-swapped weights) runs 32 -> 96,
#: and the dgrad of (2, 64^3, 192 -> 64) runs 64 -> 192
CONV_RECORD = (2, 128, 128, 128, 96, 32)

#: InstanceNorm sites (B, spatial, C, act, eps): full-res ConvNormAct,
#: PatchMerging norms (eps 1e-5), B-MHA block norms, MBConv norms, and the
#: 4^3 semantic-map norms
NORM_CASES = [(2, (128, 128, 128), 32, "relu", 1e-4),
              (2, (128, 128, 128), 32, "gelu", 1e-4),
              (2, (64, 64, 64), 256, None, 1e-5),
              (2, (32, 32, 32), 128, None, 1e-5),
              (2, (32, 32, 32), 512, "relu", 1e-4),
              (2, (16, 16, 16), 1024, "gelu", 1e-4),
              (2, (8, 8, 8), 2048, None, 1e-5),
              (2, (4, 4, 4), 320, None, 1e-5)]
NORM_RECORD = (2, (128, 128, 128), 32, "relu", 1e-4)

# Tolerances, |kernel - plain| <= atol + rtol * |plain| elementwise (the
# printed rel error is max |kernel - plain| / (|plain| + atol)):
# - fp32: both sides sum in fp32 (the norm's kernel in fp64) in other
#   orders; a wrong index or mask errs by O(1).
# - bf16: both sides compute in fp32 and round once to bf16, so they differ
#   by one bf16 ulp (2^-7 relative at most) where the fp32 values straddle a
#   rounding boundary.
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
# The conv's error is held against its largest output instead: a sum of
# 27*C products has errors of the sum's scale, not of each output's.  The
# dgrad is the same kernel and takes the same tolerance.
CONV_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}
# wgrad sums 27 taps' worth of products over every voxel (4.2 M at 2 x
# 128^3) into an fp32 dW in both versions, from the same inputs (bf16 ones
# are widened exactly); the sums run in other orders, so each entry is held
# against the largest |dW| (the sum's scale) at 1e-4 in both dtypes.
WGRAD_TOL = 1e-4
# The norm backward's statistics (means of dy' and dy' * x_hat over S) are
# fp32 outputs of fp64 sums (kernel) vs fp32 sums (plain): TOL["float32"].
# dx: TOL[dtype] as the forward apply.
#: phase 4, probabilities of two fp32 forwards (card vs CPU)
MODEL_PROB_ATOL = 1e-4
#: phase 4b, one fp32 train step card vs CPU.  The loss to 1e-5 relative.
#: The gradients of this random network are ill-conditioned in fp32 on
#: either device: against an fp64 CPU run, the CPU's fp32 gradient is off by
#: 3.2e-3 in global relative L2 (2 x 32^3), and single tensors by up to
#: 1.1e-2 (CPU) and 1.2e-2 (card, kernels or plain versions alike) of their
#: largest |grad| at 2 x 64^3, one near-zero bias by 2x.  So the whole
#: gradient is held to 2e-2 in relative L2, and each tensor to 5e-2 of (its
#: largest |grad| + 2e-2 of the model's); a wrong index, flip or layout errs
#: by O(1) of the gradient's scale.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_L2 = 2e-2
STEP_GRAD_RTOL = 5e-2
STEP_GRAD_FLOOR = 2e-2

#: a narrow MedFormer-3D with the AMOS recipe's structure (phase 4)
SMALL = dict(
    dataset="synthetic", model="medformer", dimension="3d", classes=3,
    in_chan=1, base_chan=8, chan_num=[16, 32, 64, 80, 64, 32, 16, 8],
    map_size=[2, 2, 2], conv_block="BasicBlock",
    conv_num=[2, 1, 0, 0, 0, 1, 2, 2], trans_num=[0, 1, 1, 1, 1, 1, 0, 0],
    num_heads=[1, 4, 4, 4, 4, 4, 1, 1], fusion_depth=2, fusion_dim=64,
    fusion_heads=4, expansion=4, proj_type="depthwise", norm="in",
    act="relu", kernel_size=[[3, 3, 3]] * 5, down_scale=[[2, 2, 2]] * 4,
    aux_loss=True)

#: the flagship training recipe of bench.py:70-89 (16 classes, GELU, 128^3
#: crops, bf16 with remat of every stage, AdamW, EMA) on its synthetic
#: corpus of three 192^3 volumes; one epoch of a few steps, validation off
#: (val_freq above epochs: it is not ported yet)
FLAGSHIP = dict(
    dataset="synthetic", model="medformer", dimension="3d", classes=16,
    in_chan=1, base_chan=32, conv_block="BasicBlock",
    down_scale=[[2, 2, 2]] * 4, kernel_size=[[3, 3, 3]] * 5, norm="in",
    act="gelu", map_size=[4, 4, 4], conv_num=[2, 1, 0, 0, 0, 1, 2, 2],
    trans_num=[0, 1, 4, 6, 4, 1, 0, 0], num_heads=[1, 4, 8, 10, 8, 4, 1, 1],
    expansion=4, fusion_depth=2, fusion_dim=320, fusion_heads=5,
    attn_drop=0.0, proj_drop=0.0, proj_type="depthwise", aux_loss=True,
    aux_weight=[0.5, 0.5], training_size=[128, 128, 128],
    affine_pad_size=[30, 30, 30], scale=[0.3, 0.3, 0.3],
    rotate=[30, 30, 30], translate=[0, 0, 0], gaussian_noise_std=0.02,
    additive_brightness_std=0.5, gamma_range=[0.7, 1.5],
    weight=[0.5] + [1.0] * 15, rlt=1, optimizer="adamw", base_lr=1e-3,
    betas=[0.9, 0.999], weight_decay=0.05, ema=True, ema_alpha=0.99,
    remat=True, synthetic_cases=3, synthetic_shape=[192, 192, 192],
    epochs=1, iter_per_epoch=6, print_freq=1, val_freq=2)
TRAIN_BATCH = 2
#: steps left out of the step-time median (first use of every kernel and
#: of cuDNN's algorithm search)
WARMUP_STEPS = 2

#: the model and inference keys of configs/amos_ct/medformer_3d.yaml
AMOS = dict(
    dataset="amos_ct", model="medformer", dimension="3d", classes=16,
    in_chan=1, base_chan=32, conv_block="BasicBlock",
    down_scale=[[2, 2, 2]] * 4, kernel_size=[[3, 3, 3]] * 5, norm="in",
    act="relu", map_size=[4, 4, 4], conv_num=[2, 1, 0, 0, 0, 1, 2, 2],
    trans_num=[0, 1, 4, 6, 4, 1, 0, 0], num_heads=[1, 4, 8, 10, 8, 4, 1, 1],
    expansion=4, fusion_depth=2, fusion_dim=320, fusion_heads=10,
    attn_drop=0.0, proj_drop=0.0, proj_type="depthwise",
    chan_num=[64, 128, 256, 320, 256, 128, 64, 32], aux_loss=True,
    training_size=[128, 128, 128], sliding_window=True,
    window_size=[128, 128, 128])
#: the two requests (z, y, x shape, z, y, x spacing) at target spacing
#: 1.5 mm: the AMOS evaluation volume of tools/bench_infer.py, and one that
#: the resample steps bring to 160 x 253 x 253
REQUESTS = [((160, 256, 256), (1.5, 1.5, 1.5)),
            ((96, 200, 200), (2.5, 1.9, 1.9))]
TARGET_SPACING = "1.5,1.5,1.5"


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def iters_for(flops_or_bytes: float, per_ms: float) -> int:
    """Enough calls for ~50 ms of work, at least 3."""
    return max(3, min(200, int(50 * per_ms / max(flops_or_bytes, 1.0))))


def check_close(name, out, ref, tol) -> tuple[float, float]:
    """(max abs err, max rel err); raises if an element is off."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    bad = int((diff > tol["atol"] + tol["rtol"] * mag).sum())
    err = float(diff.max())
    rel = float((diff / (mag + tol["atol"])).max())
    assert bad == 0 and math.isfinite(err), \
        f"{name}: {bad} elements off, max abs err {err:.3e}"
    return err, rel


def phase_kernels(device, conv_cases, norm_cases, record: dict) -> None:
    """Phase 3: each kernel against its plain version on ``device``."""
    import torch
    from cbim_tpu_torch.ops.kernels import conv3d, fused_norm
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    errs = {k: 0.0 for k in KERNELS}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for case in conv_cases:
            B, D, H, W, C, Fo = case
            x = torch.randn(B, D, H, W, C, generator=gen, device=device)
            w = torch.randn(Fo, C, 3, 3, 3, generator=gen, device=device)
            x, w = x.to(dtype), (w / math.sqrt(27 * C)).to(dtype)
            ref = conv3d.conv3d_same_plain(x, w)
            out = conv3d.conv3d_same(x, w)
            torch.cuda.synchronize()
            scale = float(ref.float().abs().max())
            err = float((out.float() - ref.float()).abs().max())
            ok = err <= CONV_TOL[dt] * scale
            flops = 2 * 27 * C * Fo * B * D * H * W
            n = iters_for(flops, 1e10)
            ms = cuda_ms(lambda: conv3d.conv3d_same(x, w), n)
            plain_ms = cuda_ms(lambda: conv3d.conv3d_same_plain(x, w), n)
            say(f"  conv3d_same_fwd {dt:8s} {case}: max_abs_err {err:.3e} "
                f"max_rel_err {err / scale:.3e} of max|ref| {scale:.3f} "
                f"(tol {CONV_TOL[dt]:.1e}) "
                f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s) "
                f"plain {plain_ms:.3f} ms")
            assert ok, f"conv3d_same_fwd {dt} {case}: max abs err {err:.3e}"
            errs["conv3d_same_fwd"] = max(errs["conv3d_same_fwd"], err)
            if dt == "float32" and case == CONV_RECORD:
                record["conv3d_same_fwd"] = (ms, plain_ms)
            del x, w, ref, out
        for case in norm_cases:
            B, spatial, C, act, eps = case
            S = math.prod(spatial)
            x = torch.randn(B, S, C, generator=gen, device=device) * 3 + 1.5
            x = x.to(dtype)
            mean, rstd = fused_norm.inorm_stats(x, eps)
            pmean, prstd = fused_norm.inorm_stats_plain(x, eps)
            y = fused_norm.inorm_apply(x, pmean, prstd, act)
            py = fused_norm.inorm_apply_plain(x, pmean, prstd, act)
            torch.cuda.synchronize()
            e_mean = check_close(f"inorm_stats mean {dt} {case}", mean,
                                 pmean, TOL["float32"])
            e_rstd = check_close(f"inorm_stats rstd {dt} {case}", rstd,
                                 prstd, TOL["float32"])
            e_stats = (max(e_mean[0], e_rstd[0]), max(e_mean[1], e_rstd[1]))
            e_apply = check_close(f"inorm_apply {dt} {case}", y, py, TOL[dt])
            nbytes = x.numel() * x.element_size()
            n = iters_for(nbytes, 1e9)
            st_ms = cuda_ms(lambda: fused_norm.inorm_stats(x, eps), n)
            st_plain = cuda_ms(lambda: fused_norm.inorm_stats_plain(x, eps), n)
            ap_ms = cuda_ms(lambda: fused_norm.inorm_apply(x, pmean, prstd, act), n)
            ap_plain = cuda_ms(
                lambda: fused_norm.inorm_apply_plain(x, pmean, prstd, act), n)
            say(f"  inorm {dt:8s} B={B} S={S} C={C} act={act} eps={eps}: "
                f"stats err abs {e_stats[0]:.3e} rel {e_stats[1]:.3e} "
                f"kernel {st_ms:.3f} ms "
                f"({nbytes / st_ms / 1e6:.0f} GB/s) plain {st_plain:.3f} ms | "
                f"apply err abs {e_apply[0]:.3e} rel {e_apply[1]:.3e} "
                f"kernel {ap_ms:.3f} ms "
                f"({2 * nbytes / ap_ms / 1e6:.0f} GB/s) plain {ap_plain:.3f} ms")
            errs["inorm_stats"] = max(errs["inorm_stats"], e_stats[0])
            errs["inorm_apply"] = max(errs["inorm_apply"], e_apply[0])
            if dt == "float32" and case == NORM_RECORD:
                record["inorm_stats"] = (st_ms, st_plain)
                record["inorm_apply"] = (ap_ms, ap_plain)
            del x, y, py
    record["errors"] = errs
    torch.cuda.synchronize()


def phase_backward_kernels(device, conv_cases, norm_cases, record: dict) -> None:
    """Phase 3, backward: dgrad, wgrad and the norm backward against their
    plain versions on ``device``."""
    import torch
    from cbim_tpu_torch.ops.kernels import conv3d, fused_norm
    gen = torch.Generator(device=device).manual_seed(1)
    errs = record["errors"]
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for case in conv_cases:
            B, D, H, W, C, Fo = case
            x = torch.randn(B, D, H, W, C, generator=gen, device=device)
            g = torch.randn(B, D, H, W, Fo, generator=gen, device=device)
            w = torch.randn(Fo, C, 3, 3, 3, generator=gen, device=device)
            x, g = x.to(dtype), g.to(dtype)
            w = (w / math.sqrt(27 * Fo)).to(dtype)
            dx = conv3d.conv3d_dgrad(g, w)
            ref_dx = conv3d.conv3d_same_plain(g, conv3d.flip_swap(w))
            dw = conv3d.conv3d_wgrad(x, g)
            ref_dw = conv3d.conv3d_wgrad_plain(x, g)
            torch.cuda.synchronize()
            sx = float(ref_dx.float().abs().max())
            ex = float((dx.float() - ref_dx.float()).abs().max())
            sw = float(ref_dw.abs().max())
            ew = float((dw - ref_dw).abs().max())
            flops = 2 * 27 * C * Fo * B * D * H * W
            n = iters_for(flops, 1e10)
            dx_ms = cuda_ms(lambda: conv3d.conv3d_dgrad(g, w), n)
            dx_plain = cuda_ms(
                lambda: conv3d.conv3d_same_plain(g, conv3d.flip_swap(w)), n)
            dw_ms = cuda_ms(lambda: conv3d.conv3d_wgrad(x, g), n)
            dw_plain = cuda_ms(lambda: conv3d.conv3d_wgrad_plain(x, g), n)
            say(f"  conv3d_dgrad    {dt:8s} {case}: max_abs_err {ex:.3e} "
                f"max_rel_err {ex / sx:.3e} (tol {CONV_TOL[dt]:.1e}) "
                f"kernel {dx_ms:.3f} ms ({flops / dx_ms / 1e9:.1f} TFLOP/s) "
                f"plain {dx_plain:.3f} ms")
            say(f"  conv3d_wgrad    {dt:8s} {case}: max_abs_err {ew:.3e} "
                f"max_rel_err {ew / sw:.3e} of max|dW| {sw:.1f} "
                f"(tol {WGRAD_TOL:.1e}) kernel {dw_ms:.3f} ms "
                f"({flops / dw_ms / 1e9:.1f} TFLOP/s) plain {dw_plain:.3f} ms")
            assert ex <= CONV_TOL[dt] * sx, f"conv3d_dgrad {dt} {case}: {ex:.3e}"
            assert ew <= WGRAD_TOL * sw, f"conv3d_wgrad {dt} {case}: {ew:.3e}"
            errs["conv3d_same_fwd"] = max(errs["conv3d_same_fwd"], ex)
            errs["conv3d_wgrad"] = max(errs["conv3d_wgrad"], ew)
            if dt == "float32" and case == CONV_RECORD:
                record["conv3d_wgrad"] = (dw_ms, dw_plain)
                record["conv3d_dgrad"] = (dx_ms, dx_plain)
            del x, g, w, dx, ref_dx, dw, ref_dw
        for case in norm_cases:
            B, spatial, C, act, eps = case
            S = math.prod(spatial)
            x = torch.randn(B, S, C, generator=gen, device=device) * 3 + 1.5
            dy = torch.randn(B, S, C, generator=gen, device=device)
            x, dy = x.to(dtype), dy.to(dtype)
            mean, rstd = fused_norm.inorm_stats_plain(x, eps)
            red = fused_norm.inorm_bwd_stats(x, dy, mean, rstd, act)
            pred = fused_norm.inorm_bwd_stats_plain(x, dy, mean, rstd, act)
            dx = fused_norm.inorm_bwd_apply(x, dy, mean, rstd, pred, act)
            pdx = fused_norm.inorm_bwd_apply_plain(x, dy, mean, rstd, pred, act)
            torch.cuda.synchronize()
            e_red = check_close(f"inorm_bwd_stats {dt} {case}", red, pred,
                                TOL["float32"])
            e_dx = check_close(f"inorm_bwd_apply {dt} {case}", dx, pdx, TOL[dt])
            nbytes = x.numel() * x.element_size()
            n = iters_for(nbytes, 1e9)
            st_ms = cuda_ms(
                lambda: fused_norm.inorm_bwd_stats(x, dy, mean, rstd, act), n)
            st_plain = cuda_ms(
                lambda: fused_norm.inorm_bwd_stats_plain(x, dy, mean, rstd,
                                                         act), n)
            ap_ms = cuda_ms(lambda: fused_norm.inorm_bwd_apply(
                x, dy, mean, rstd, pred, act), n)
            ap_plain = cuda_ms(lambda: fused_norm.inorm_bwd_apply_plain(
                x, dy, mean, rstd, pred, act), n)
            say(f"  inorm bwd {dt:8s} B={B} S={S} C={C} act={act}: "
                f"stats err abs {e_red[0]:.3e} rel {e_red[1]:.3e} "
                f"kernel {st_ms:.3f} ms ({2 * nbytes / st_ms / 1e6:.0f} GB/s) "
                f"plain {st_plain:.3f} ms | apply err abs {e_dx[0]:.3e} "
                f"rel {e_dx[1]:.3e} kernel {ap_ms:.3f} ms "
                f"({3 * nbytes / ap_ms / 1e6:.0f} GB/s) plain {ap_plain:.3f} ms")
            errs["inorm_bwd_stats"] = max(errs["inorm_bwd_stats"], e_red[0])
            errs["inorm_bwd_apply"] = max(errs["inorm_bwd_apply"], e_dx[0])
            if dt == "float32" and case == NORM_RECORD:
                record["inorm_bwd_stats"] = (st_ms, st_plain)
                record["inorm_bwd_apply"] = (ap_ms, ap_plain)
            del x, dy, dx, pdx
    torch.cuda.synchronize()


def phase_small_model(device, size: int) -> float:
    """Phase 4: the small model on ``device`` vs the CPU, same weights."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    cfg = config_from_dict(SMALL)
    cpu_model = get_model(cfg, generator=torch.Generator().manual_seed(1))
    dev_model = get_model(cfg, device=device)
    dev_model.load_state_dict(cpu_model.state_dict())
    x = torch.randn(1, 1, size, size, size,
                    generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        ref = torch.softmax(cpu_model(x)[0], dim=1)
        out = torch.softmax(dev_model(x.to(device))[0], dim=1).cpu()
    err = float((out - ref).abs().max())
    assert out.shape == (1, SMALL["classes"], size, size, size)
    assert torch.isfinite(out).all() and err <= MODEL_PROB_ATOL, err
    return err


def phase_small_train_step(device, size: int) -> tuple[float, float, float]:
    """Phase 4b: one fp32 train step of the small model on ``device`` and
    on the CPU, same weights and batch.  Returns (loss relative error,
    the gradient's relative L2 error, the worst tensor's error against its
    tolerance scale)."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.ops.losses import deep_supervision_loss
    cfg = config_from_dict(dict(SMALL, remat=True))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = get_model(cfg, train=True,
                          generator=torch.Generator().manual_seed(3))
    dev_model = get_model(cfg, device=device, train=True)
    dev_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(4)
    img = torch.randn(2, 1, size, size, size, generator=gen)
    lab = torch.randint(0, SMALL["classes"], (2, size, size, size),
                        generator=gen)
    weight = [0.5] + [1.0] * (SMALL["classes"] - 1)
    results = []
    for model, dev in ((cpu_model, torch.device("cpu")), (dev_model, device)):
        loss = deep_supervision_loss(model(img.to(dev)), lab.to(dev),
                                     [0.5, 0.5], weight)
        loss.backward()
        results.append((float(loss.detach()), {k: p.grad.cpu() for k, p in
                                      model.named_parameters()}))
    (ref_loss, ref_grads), (loss, grads) = results
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    assert math.isfinite(loss) and loss_err <= STEP_LOSS_RTOL, loss_err
    l2_err = math.sqrt(sum(float((grads[k] - r).square().sum())
                           for k, r in ref_grads.items())
                       / sum(float(r.square().sum()) for r in ref_grads.values()))
    assert l2_err <= STEP_GRAD_L2, f"gradient relative L2 error {l2_err:.3e}"
    top = max(float(r.abs().max()) for r in ref_grads.values())
    worst = 0.0
    for k, ref in ref_grads.items():
        # every parameter gets a finite gradient through the card's graph
        assert torch.isfinite(grads[k]).all(), k
        assert float(grads[k].abs().max()) > 0 or float(ref.abs().max()) == 0, k
        scale = float(ref.abs().max()) + STEP_GRAD_FLOOR * top
        err = float((grads[k] - ref).abs().max())
        assert err <= STEP_GRAD_RTOL * scale, f"{k}: {err:.3e} of {scale:.3e}"
        worst = max(worst, err / scale)
    return loss_err, l2_err, worst


def write_requests(in_dir: str, requests, seed: int = 0) -> None:
    """Synthetic CT-like volumes (HU) from numpy, seeded."""
    import numpy as np
    from cbim_tpu_torch.data.nifti import write_nifti
    rng = np.random.default_rng(seed)
    os.makedirs(in_dir, exist_ok=True)
    for i, (shape, spacing) in enumerate(requests):
        vol = rng.normal(0.0, 400.0, size=shape).astype(np.float32)
        write_nifti(os.path.join(in_dir, f"req{i}.nii.gz"),
                    np.clip(vol, -1024, 3000).astype(np.int16),
                    spacing=spacing)


def phase_slice(device, cfg_dict, requests, target_spacing) -> dict:
    """Phase 5: serve ``requests`` with seeded weights through prediction."""
    import numpy as np
    import torch
    from cbim_tpu_torch import prediction
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.data.nifti import read_nifti
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    in_dir, out_dir = os.path.join(WORK, "in"), os.path.join(WORK, "out")
    cfg = config_from_dict(cfg_dict)
    weights = os.path.join(WORK, "medformer_seed0.pth")
    torch.save(get_model(cfg, generator=torch.Generator().manual_seed(0))
               .state_dict(), weights)
    write_requests(in_dir, requests)
    argv = ["--dataset", cfg.dataset, "--model", "medformer",
            "--dimension", "3d", "--load", weights, "--img_path", in_dir,
            "--save_path", out_dir, "--target_spacing", target_spacing,
            "--device", str(device)]

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    seconds = prediction.main(argv, cfg=cfg)
    counts = launch_counts()

    assert len(seconds) == len(requests), seconds
    for name in sorted(seconds):
        src = read_nifti(os.path.join(in_dir, name))
        pred = read_nifti(os.path.join(out_dir, name)).data
        assert pred.shape == src.data.shape, (name, pred.shape)
        assert pred.dtype == np.uint8 and int(pred.max()) < cfg.classes
    result = {"seconds": seconds, "launches": counts}
    if device.type == "cuda":
        result["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        missing = [k for k in FORWARD_KERNELS if counts[k] == 0]
        assert not missing, f"kernels never launched on the path: {missing}"
    return result


def phase_train(device, cfg_dict) -> dict:
    """Phase 6: train the flagship recipe a few steps through
    ``cbim_tpu_torch.train.main``; per-step losses and seconds come from the
    run's scalars.jsonl (one loss fetch per step)."""
    import torch
    from cbim_tpu_torch import train
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    cfg = config_from_dict(cfg_dict)
    run = os.path.join(WORK, "train")
    argv = ["--dataset", cfg.dataset, "--model", "medformer", "--dimension",
            "3d", "--batch_size", str(TRAIN_BATCH), "--amp",
            "--cp_path", os.path.join(run, "exp"),
            "--log_path", os.path.join(run, "log"), "--unique_name",
            "flagship", "--folds", "1", "--device", str(device)]

    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    train.main(argv, cfg=cfg)
    seconds = time.perf_counter() - t0
    counts = launch_counts()

    rows = [json.loads(ln) for ln in open(os.path.join(
        run, "log", cfg.dataset, "flagship", "fold_0", "scalars.jsonl"))]
    step_loss = [r["value"] for r in rows if r["tag"] == "Train/StepLoss"]
    step_s = [r["value"] for r in rows if r["tag"] == "Perf/StepSeconds"]
    assert len(step_loss) == cfg.iter_per_epoch, rows
    assert all(math.isfinite(v) for v in step_loss), step_loss
    assert os.path.exists(os.path.join(run, "exp", cfg.dataset, "flagship",
                                       "fold_0_latest.ckpt"))
    missing = [k for k in (*KERNELS, "conv3d_dgrad") if counts[k] == 0]
    assert not missing, f"kernels never launched on the path: {missing}"
    median = statistics.median(step_s[WARMUP_STEPS:])
    return {"losses": step_loss, "step_seconds": step_s, "median": median,
            "vols_per_s": TRAIN_BATCH / median, "seconds": seconds,
            "peak_bytes": torch.cuda.max_memory_allocated(device),
            "launches": counts}


def main() -> int:
    t_start = time.perf_counter()

    import torch
    say("[phase 1] device")
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is False")
        return 1
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != (9, 0):
        say(f"FAIL: compute capability {cap}, the kernels need 9.0")
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    say(card)
    say(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    sys.path.insert(0, ROOT)
    from cbim_tpu_torch.ops.kernels import _build
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    say("[phase 2] build")
    _build.library()
    with open(os.path.join(WORK, "build.log"), "w") as f:
        f.write(_build.build_log)
    regs = [ln.split(":", 1)[1].strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    say(f"  built {_build.library_path().name} in "
        f"{_build.build_seconds:.1f} s; ptxas per kernel: {'; '.join(regs)}")

    record: dict = {}
    say("[phase 3] kernels vs plain versions")
    phase_kernels(device, CONV_CASES, NORM_CASES, record)
    phase_backward_kernels(device, CONV_CASES, NORM_CASES, record)

    say("[phase 4] small MedFormer-3D, card vs CPU")
    err = phase_small_model(device, 64)
    say(f"  64^3 softmax max abs err {err:.3e} (tol {MODEL_PROB_ATOL})")

    say("[phase 4b] one train step of the small MedFormer-3D, card vs CPU")
    loss_err, l2_err, grad_err = phase_small_train_step(device, 64)
    say(f"  2 x 64^3 fp32: loss rel err {loss_err:.3e} "
        f"(tol {STEP_LOSS_RTOL:.0e}); gradient rel L2 err {l2_err:.3e} "
        f"(tol {STEP_GRAD_L2:.0e}); worst tensor err {grad_err:.3e} of its "
        f"scale (tol {STEP_GRAD_RTOL:.0e})")

    say("[phase 5] AMOS-CT MedFormer-3D serving 2 NIfTI requests")
    res = phase_slice(device, AMOS, REQUESTS, TARGET_SPACING)
    secs = res["seconds"]
    say(f"  sec/volume {sum(secs.values()) / len(secs):.3f} "
        f"({', '.join(f'{k} {v:.3f}' for k, v in sorted(secs.items()))})"
        f"; peak device memory {res['peak_bytes'] / 2 ** 30:.2f} GiB; "
        f"launches {res['launches']}")

    say("[phase 6] flagship MedFormer-3D training, bf16, remat all, "
        f"batch {TRAIN_BATCH}, {FLAGSHIP['iter_per_epoch']} steps")
    tr = phase_train(device, FLAGSHIP)
    say(f"  losses {', '.join(f'{v:.4f}' for v in tr['losses'])}")
    say(f"  step seconds {', '.join(f'{v:.3f}' for v in tr['step_seconds'])}"
        f"; median after {WARMUP_STEPS} steps {tr['median']:.3f} s/step, "
        f"{tr['vols_per_s']:.3f} volumes/s; peak device memory "
        f"{tr['peak_bytes'] / 2 ** 30:.2f} GiB; train.main {tr['seconds']:.1f} s")
    say(f"  launches (the recomputed forward included) {tr['launches']}")
    record["launches"] = tr["launches"]
    jax_mods = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax")]
    assert not jax_mods, f"the port loaded JAX modules: {jax_mods[:5]}"
    say(f"  dgrad of conv3d_same_fwd at {CONV_RECORD}, fp32: kernel "
        f"{record['conv3d_dgrad'][0]:.3f} ms, plain {record['conv3d_dgrad'][1]:.3f} ms")

    say(f"  total {time.perf_counter() - t_start:.1f} s")
    say(card_line())
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": record["launches"][name],
         "max_abs_err": record["errors"][name],
         "ms": record[name][0], "plain_ms": record[name][1]}
        for name, (src, rep) in KERNELS.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
