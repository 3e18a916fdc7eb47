#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cbim_tpu_torch``) on one NVIDIA H100.

Phases, each printing its result; any failure raises and exits non-zero:

1. device: a CUDA card of compute capability 9.0; its name and power limit
   as ``nvidia-smi`` reports them;
2. build: the CUDA kernels from ``cbim_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernels vs their plain PyTorch versions on the card, at the serving
   path's shapes, fp32 and bf16: max error against stated tolerances, and
   each kernel's time beside its plain version's;
4. a small MedFormer-3D on a 64^3 input, same seeded weights, on the card
   (kernels) and on the CPU (plain versions): softmax outputs compared;
5. the slice: the full-width AMOS-CT MedFormer-3D with seeded random weights
   serves two synthetic NIfTI requests through
   ``cbim_tpu_torch.prediction.main``; every kernel must have launched.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import os
import shutil
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
}

#: 3^3 conv shapes of the serving path (B, D, H, W, C, F): inc/up4 at
#: 128^3, down1/up3 at 64^3, down2/up2 at 32^3, plus a ragged shape
CONV_CASES = [(2, 128, 128, 128, 32, 32), (2, 128, 128, 128, 96, 32),
              (2, 64, 64, 64, 64, 64), (2, 64, 64, 64, 192, 64),
              (2, 32, 32, 32, 128, 128), (2, 17, 23, 30, 24, 40)]
#: the conv case whose times go into the JSON record (up4's widest conv)
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
# 27*C products has errors of the sum's scale, not of each output's.
CONV_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}
#: phase 4, probabilities of two fp32 forwards (card vs CPU)
MODEL_PROB_ATOL = 1e-4

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
        missing = [k for k, v in counts.items() if v == 0]
        assert not missing, f"kernels never launched on the path: {missing}"
    return result


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

    say("[phase 4] small MedFormer-3D, card vs CPU")
    err = phase_small_model(device, 64)
    say(f"  64^3 softmax max abs err {err:.3e} (tol {MODEL_PROB_ATOL})")

    say("[phase 5] AMOS-CT MedFormer-3D serving 2 NIfTI requests")
    res = phase_slice(device, AMOS, REQUESTS, TARGET_SPACING)
    secs = res["seconds"]
    say(f"  sec/volume {sum(secs.values()) / len(secs):.3f} "
        f"({', '.join(f'{k} {v:.3f}' for k, v in sorted(secs.items()))})"
        f"; peak device memory {res['peak_bytes'] / 2 ** 30:.2f} GiB; "
        f"launches {res['launches']}")
    record["launches"] = res["launches"]
    jax_mods = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax")]
    assert not jax_mods, f"the port loaded JAX modules: {jax_mods[:5]}"

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
