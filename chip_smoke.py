#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cbim_tpu_torch``) on one NVIDIA H100.

Phases, each printing its result; any failure raises and exits non-zero:

1. device: a CUDA card of compute capability 9.0; its name and power limit
   as ``nvidia-smi`` reports them;
2. build: the CUDA kernels from ``cbim_tpu_torch/csrc`` (one nvcc per
   source, all started together; sm_90a);
3. kernels vs their plain PyTorch versions on the card, at the serving and
   training paths' shapes, fp32 and bf16, forward and backward, the 3^3
   and the 3x3 conv families: max error against stated tolerances, and
   each kernel's time beside its plain version's and the one PyTorch call
   that computes the same function (cuDNN's conv or weight gradient); the
   3^3 conv cases assert their route (``conv3d_route``: at widths of
   multiples of 8 bf16 takes the tensor-core kernels ``conv3d_same_fwd_tc``
   and ``conv3d_wgrad_tc`` and fp32 the 3xTF32 kernels
   ``conv3d_same_fwd_tf32`` (also the dgrad) and ``conv3d_wgrad_tf32``,
   the rest the CUDA-core ones, which are held and timed beside the others
   too; the TF32 kernels' and cuDNN fp32's errors against an fp64 conv or
   weight gradient are printed, and the kernels' may be at most twice
   cuDNN's), and so do the 3x3 cases
   (``conv2d_route``: at widths of multiples of 8 ``conv2d_same_fwd_tc``
   and ``conv2d_wgrad_tc`` in bf16 and the 3xTF32 ``conv2d_same_fwd_tf32``
   (also the dgrad) and ``conv2d_wgrad_tf32`` in fp32, their fp64 errors
   held against cuDNN fp32's as the 3^3 ones are; the CUDA-core
   ``conv2d_same_fwd`` and ``conv2d_wgrad`` beside them and for the
   rest); and
   cuDNN's depthwise 3x3 conv in both memory formats, the layout choice of
   MedFormer-2D's grouped convs; the window-attention kernel (tensor
   cores: 3xTF32 in fp32, bf16 mma in bf16) at the Swin zoo's seven
   shapes, with and without a shifted-window mask, beside
   ``F.scaled_dot_product_attention`` on the same bias, in fp32 its error
   against an fp64 evaluation at most twice SDPA fp32's, SwinUNETR's three
   shapes timed; the fused preact conv's kernels at the 3^3 conv shapes,
   relu and gelu, on the route of ``conv3d_route`` (at widths of
   multiples of 8 bf16: ``conv3d_same_na_fwd_tc`` and
   ``conv3d_wgrad_na_tc``, fp32: ``conv3d_same_na_fwd_tf32`` and
   ``conv3d_wgrad_na_tf32``, with the CUDA-core fused pair they replace
   held and timed beside them, and the fp32 ones' errors against fp64 at
   most twice cuDNN fp32's; the rest: the CUDA-core pair), each beside the
   unfused pair of kernels it replaces (no single PyTorch call computes
   either); and the card's NaN at one voxel of x and of g through the
   TF32 forward, dgrad, fused forward, wgrad and fused wgrad and
   ``inorm_apply``, and
   at one pixel through the 3x3 TF32 forward, dgrad and wgrad: NaN
   exactly where it enters each output, finite elsewhere;
3a. the augmentation ops (``cbim_tpu_torch.ops.augment``, the pipeline's
   device part) on the card against the same ops on the CPU with the same
   drawn scalars, at KiTS's post-crop batch (2 x 128^3) and ACDC-3D's
   full-volume cache rows: gamma (plain and masked), contrast, the blur at
   the range's lowest and highest sigma, mirror on every axis, additive
   brightness, the ``std_range`` noise with its noise tensor given, elastic
   with its control points given, and ``affine_sample_3d_fullvol_batch``;
   the image within 1e-5 of max|ref|, the labels equal;
4. a small MedFormer-3D on a 64^3 input, same seeded weights, on the card
   (kernels) and on the CPU (plain versions): softmax outputs compared;
   then again with ``conv_na`` (the fused preact conv);
4b. one train step of that small model, card vs CPU, fp32 with TF32 off
   (its 3^3 forwards, dgrads and wgrads on the 3xTF32 kernels; with
   ``conv_na`` the fused pair's too): the loss and every
   parameter's gradient compared; again with ``conv_na``; then a
   bf16-autocast step on the card (the tensor-core kernels only) against
   the fp32 CPU step, again with ``conv_na`` (the
   tensor-core fused pair), and the same step on the CUDA-core kernels
   beside them (bf16's own error on this network);
4c. the same two checks for a small MedFormer-2D (BatchNorm, 128^2 slices):
   eval-mode softmax, then one train-mode fp32 step; with ``conv2d_kernel``
   on, as phases 7 and 8 (the 3x3 kernel route is opt-in, as the JAX
   package's ``CBIM_PLCONV2D=1``): fp32 on the 3xTF32 3x3 kernels only;
4d. a small SwinUNETR (feature size 48, on 2 x 64^3 and 1 x 32^3), card
   (window-attention kernel) vs CPU (plain version): softmax outputs;
4e. ``validate`` (``cbim_tpu_torch.training.validation``) of phase 4's
   small MedFormer-3D, same seeded weights, on one 72 x 64 x 80
   Synthetic3D test volume by 64^3 sliding window, card (fp32: the TF32
   forwards) vs CPU: the label maps agree on at least 99.9 % of voxels and
   each class's Dice within 1e-3;
5. serving: the full-width AMOS-CT MedFormer-3D with seeded random weights
   serves two synthetic NIfTI requests through
   ``cbim_tpu_torch.prediction.main``; every forward kernel must have
   launched, fp32: every 3^3 conv one ``conv3d_same_fwd_tf32`` launch, 20
   a forward, and no other 3^3 kernel (the CUDA-core fp32 forward launches
   on no full-width path: phase 3 holds it at every conv case and the
   ragged 20 -> 36 takes it, phase 10's ladder is its code);
5b. the same requests with ``conv_na: true``: every conv of the BasicBlocks
   is one ``conv3d_same_na_fwd_tf32`` launch, 20 a forward, and no other
   3^3 kernel launches; the label maps agree with phase 5's;
6. training: the flagship recipe (``bench.py``: full-width MedFormer-3D,
   GELU, 128^3 crops, batch 2, bf16 autocast, remat of every stage, AdamW,
   EMA) trains a few steps on the synthetic corpus through
   ``cbim_tpu_torch.train.main``; every kernel, backward ones included,
   must have launched, and every loss must be finite.  Launch counts
   include the forward that remat recomputes in the backward pass: per
   step 40 ``conv3d_same_fwd_tc``, 20 ``conv3d_dgrad_tc`` and 20
   ``conv3d_wgrad_tc``, and no CUDA-core 3^3 launch;
6b. the same recipe with ``conv_na: true``: per step 40
   ``conv3d_same_na_fwd_tc`` (remat incl.), 20 ``conv3d_wgrad_na_tc`` and
   20 ``conv3d_dgrad_tc`` launches, no other 3^3 launch (the CUDA-core
   fused pair none); sec/step and peak memory beside phase 6's;
6v. validation: the flagship recipe with ``val_freq`` 1 on five 130^3
   volumes (fold 0 of 5: one test volume) trains two steps, then its
   epoch ends in the EMA model's evaluation by 128^3 sliding window (8
   windows, 2 forwards at the auto window batch of 4), in bf16 like the
   step: 20 ``conv3d_same_fwd_tc`` launches per evaluation forward beside
   the steps' (no fp32 3^3 launch); the returned Dice, HD95 and ASD have
   15 finite entries and ``fold_0_best.ckpt`` exists; the window sweep's
   and the host distances' seconds per volume and the sweep's peak
   memory;
6k. the KiTS recipe as a user trains it: ``configs/kits/medformer_3d.yaml``
   as shipped (MedFormer-3D, base 32, 3 classes, 128^3 crops, remat, the
   KiTS augmentation with its 60-voxel affine pad), read by the port's
   ``load_config``, trained through ``cbim_tpu_torch.train.main --dataset
   kits`` in fp32 (the CLI's default: no ``--amp``) at batch 2 for 6 steps
   on 5 HU-like int16 NIfTI cases the script writes (about 1.25x the crop,
   fold 0 of 5), fed from host windows in pinned memory
   (``device_cache: false``: a real KiTS corpus is far over the cache's
   4 GB); every loss finite, and per step 32 ``conv3d_same_fwd_tf32``
   (remat incl.), 16 ``conv3d_dgrad_tf32`` and 16 ``conv3d_wgrad_tf32``
   launches, no tensor-core and no CUDA-core 3^3 launch; sec/step (median of
   the 4 steps after warm-up), peak memory and the batches' time alone;
6kn. the same recipe with ``conv_na: true`` for 4 steps: every one of its
   16 kernel convs fused, per step 32 ``conv3d_same_na_fwd_tf32`` (remat
   incl.), 16 ``conv3d_dgrad_tf32`` and 16 ``conv3d_wgrad_na_tf32``
   launches and no other 3^3 launch (the CUDA-core ``conv3d_wgrad_na``
   none); sec/step beside phase 6k's;
6a. the ACDC-3D recipe (``configs/acdc/medformer_3d.yaml``: 16 x 192 x 192
   crops, 4 classes, fp32, batch 2) for 6 steps on 6 written cases of two
   frames: the pipeline took the device cache and its full-volume path (one
   full-volume resample a step), every loss finite; sec/step (median of
   4) and the batches' time alone;
7. 2D serving: the full-width ACDC MedFormer-2D with seeded random weights
   serves two synthetic cine-MR NIfTI requests through
   ``cbim_tpu_torch.prediction.main --dimension 2d`` (every slice of a
   volume is the batch at each window position); fp32: every 3x3 kernel
   conv one ``conv2d_same_fwd_tf32`` launch, 14 a forward, and no other
   3x3 kernel; then the same requests with ``conv2d_kernel`` off (cuDNN
   fp32, TF32 off): the label maps agree on at least 99.9 % of pixels;
8. 2D training: the ACDC recipe (``configs/acdc/medformer_2d.yaml``)
   trains an epoch of batch-32 steps on ``Synthetic2D`` through
   ``cbim_tpu_torch.train.main --dimension 2d --amp``; every loss must be
   finite, and per step the 14 3x3 kernel convs make 14
   ``conv2d_same_fwd_tc``, 14 ``conv2d_dgrad_tc`` and 14
   ``conv2d_wgrad_tc`` launches, and no CUDA-core 3x3 launch;
8b. the same recipe with ``conv2d_kernel`` off, the default: the 3x3 convs
   are cuDNN's and no 3x3 kernel of any route launches; sec/step,
   slices/s and peak memory beside phase 8's;
8f. the same recipe in fp32 (the CLI's default: no ``--amp``) with
   ``conv2d_kernel`` on, 6 steps at batch 32: every loss finite, and per
   step 14 ``conv2d_same_fwd_tf32``, 14 ``conv2d_dgrad_tf32`` and 14
   ``conv2d_wgrad_tf32`` launches and no other 3x3 kernel; sec/step and
   peak memory beside phase 8's;
8v. 2D validation: the ACDC recipe with ``val_freq`` 1 on 10 cases trains
   one step, then evaluates the EMA model on the 2 test volumes (every
   slice of a volume the batch, centre-cropped to 256^2, whole image), in
   bf16 on the 3x3 kernel route: 14 ``conv2d_same_fwd_tc`` launches per
   evaluation forward; seconds per volume as in 6v;
9. Swin serving: the full-width BCV SwinUNETR (``configs/bcv/
   swin_unetr_3d.yaml``: 14 classes, feature size 48, 128^3 window, fp32)
   with seeded random weights serves phase 5's two requests through
   ``cbim_tpu_torch.prediction.main --model swin_unetr``; the window-
   attention kernel must have launched once per Swin block of every
   forward, 6 per forward;
10. the probes (``cbim_tpu_torch.tools``, the port of the JAX package's TPU
   probes in ``tools/``): ``probe_bandwidth``, ``probe_lhst_dot`` and
   ``probe_conv_dissect`` run at their full sizes, each of the four probe
   kernels (``probe_copy_scale``, ``probe_dot_t``, ``probe_gemm``, the
   ``conv3d_same_fwd`` ladder) must have launched; then each is held against
   its plain version (the copy-scale exactly, the bf16 dots within 2^-7 of
   max|ref|, the ladder's ``full`` rung within the conv's tolerance and in
   fp32 equal to the CUDA-core forward it cuts; ``conv3d_same`` of the
   route, the tensor-core or TF32 kernel, within the conv's tolerance and
   timed beside the rungs), with its time, bound, plain and library
   times.

Each of phases 4e and 5-10 (5b, 6b, 6v, 6k, 6kn, 6a, 7b, 8b, 8f and 8v
included) sets
the launch counters to 0 just before it and reads them just after.  The
last three
lines are the card's name and power limit, the kernels' JSON record
(launches by phase, errors, times, the bound from the recorded shape's
FLOPs and bytes) and ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--profile DIR]

``--profile DIR`` also traces the steady steps of phases 6, 6b, 6k, 6kn,
6a, 8, 8b and 8f with the trainer's profiler hook (``profile_dir``), and the
requests of phases 5, 5b and 9 served a second time, after the timed run:
DIR/<phase>/kernels.txt and summary.json, and the top kernels by device
time are printed; for 5 and 5b also the 3^3 forwards' shapes and counts.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import shutil
import statistics
import sys
import time

# the timing and the bound (published H100 peaks) that the probes use too
from cbim_tpu_torch.tools import HBM_BYTES_PER_S, bound_ms, card_line, cuda_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

#: TPU kernels each CUDA kernel replaces (file:line of the function that
#: reaches pl.pallas_call)
KERNELS = {
    # and the fused preact conv's statistics (_cw_stats: the same mean and
    # rstd in the TPU layout)
    "inorm_stats": ("cbim_tpu_torch/csrc/fused_norm.cu",
                    "cbim_tpu/ops/pallas/fused_norm.py:223, "
                    "cbim_tpu/ops/pallas/conv3d.py:1570"),
    "inorm_apply": ("cbim_tpu_torch/csrc/fused_norm.cu",
                    "cbim_tpu/ops/pallas/fused_norm.py:241"),
    "conv3d_same_fwd": ("cbim_tpu_torch/csrc/conv3d.cu",
                        "cbim_tpu/ops/pallas/conv3d.py:299"),
    "conv3d_wgrad": ("cbim_tpu_torch/csrc/conv3d_wgrad.cu",
                     "cbim_tpu/ops/pallas/conv3d.py:582"),
    "inorm_bwd_stats": ("cbim_tpu_torch/csrc/fused_norm.cu",
                        "cbim_tpu/ops/pallas/fused_norm.py:257"),
    "inorm_bwd_apply": ("cbim_tpu_torch/csrc/fused_norm.cu",
                        "cbim_tpu/ops/pallas/fused_norm.py:257"),
    "conv2d_same_fwd": ("cbim_tpu_torch/csrc/conv2d.cu",
                        "cbim_tpu/ops/pallas/conv2d.py:115"),
    "conv2d_wgrad": ("cbim_tpu_torch/csrc/conv2d.cu",
                     "cbim_tpu/ops/pallas/conv2d.py:238"),
    "window_attention": ("cbim_tpu_torch/csrc/window_attention.cu",
                         "cbim_tpu/ops/pallas/window_attention.py:78"),
    "conv3d_same_na_fwd": ("cbim_tpu_torch/csrc/conv3d.cu",
                           "cbim_tpu/ops/pallas/conv3d.py:1387"),
    # the bf16 route at widths of multiples of 8 (conv3d.conv3d_route)
    "conv3d_same_fwd_tc": ("cbim_tpu_torch/csrc/conv3d_tc.cu",
                           "cbim_tpu/ops/pallas/conv3d.py:299"),
    "conv3d_wgrad_tc": ("cbim_tpu_torch/csrc/conv3d_wgrad_tc.cu",
                        "cbim_tpu/ops/pallas/conv3d.py:582"),
    # the bf16 3x3 route at widths of multiples of 8 (conv2d.conv2d_route)
    "conv2d_same_fwd_tc": ("cbim_tpu_torch/csrc/conv2d_tc.cu",
                           "cbim_tpu/ops/pallas/conv2d.py:115"),
    "conv2d_wgrad_tc": ("cbim_tpu_torch/csrc/conv2d_wgrad_tc.cu",
                        "cbim_tpu/ops/pallas/conv2d.py:238"),
    # the fp32 3x3 route at widths of multiples of 8 (3xTF32): the forward
    # and dgrad, and the weight gradient
    "conv2d_same_fwd_tf32": ("cbim_tpu_torch/csrc/conv2d_tf32.cu",
                             "cbim_tpu/ops/pallas/conv2d.py:115"),
    "conv2d_wgrad_tf32": ("cbim_tpu_torch/csrc/conv2d_wgrad_tf32.cu",
                          "cbim_tpu/ops/pallas/conv2d.py:238"),
    "conv3d_wgrad_na": ("cbim_tpu_torch/csrc/conv3d_wgrad_na.cu",
                        "cbim_tpu/ops/pallas/conv3d.py:1518"),
    # the fused pair's bf16 route at widths of multiples of 8
    "conv3d_same_na_fwd_tc": ("cbim_tpu_torch/csrc/conv3d_na_tc.cu",
                              "cbim_tpu/ops/pallas/conv3d.py:1387"),
    "conv3d_wgrad_na_tc": ("cbim_tpu_torch/csrc/conv3d_wgrad_na_tc.cu",
                           "cbim_tpu/ops/pallas/conv3d.py:1518"),
    # and its fp32 route (3xTF32)
    "conv3d_wgrad_na_tf32": ("cbim_tpu_torch/csrc/conv3d_wgrad_na_tf32.cu",
                             "cbim_tpu/ops/pallas/conv3d.py:1518"),
    # the fp32 route at widths of multiples of 8 (3xTF32): the forward and
    # dgrad, and the fused forward
    "conv3d_same_fwd_tf32": ("cbim_tpu_torch/csrc/conv3d_tf32.cu",
                             "cbim_tpu/ops/pallas/conv3d.py:299"),
    "conv3d_same_na_fwd_tf32": ("cbim_tpu_torch/csrc/conv3d_tf32.cu",
                                "cbim_tpu/ops/pallas/conv3d.py:1387"),
    # and its weight gradient
    "conv3d_wgrad_tf32": ("cbim_tpu_torch/csrc/conv3d_wgrad_tf32.cu",
                          "cbim_tpu/ops/pallas/conv3d.py:582"),
    # the probes, which lie on no path but their own entry points (phase 10)
    "probe_copy_scale": ("cbim_tpu_torch/csrc/probes.cu",
                         "tools/probe_bandwidth.py:23"),
    "probe_dot_t": ("cbim_tpu_torch/csrc/probes.cu",
                    "tools/probe_lhst_dot.py:28"),
    "probe_gemm": ("cbim_tpu_torch/csrc/probes.cu",
                   "tools/probe_lhst_dot.py:96"),
    "conv3d_same_fwd_ladder": ("cbim_tpu_torch/csrc/conv3d.cu",
                               "tools/probe_cw_dissect.py:164"),
}
#: the launch counter of each forward kernel's input-gradient launches
DGRAD = {"conv3d_same_fwd": "conv3d_dgrad", "conv2d_same_fwd": "conv2d_dgrad",
         "conv3d_same_fwd_tc": "conv3d_dgrad_tc",
         "conv2d_same_fwd_tc": "conv2d_dgrad_tc",
         "conv3d_same_fwd_tf32": "conv3d_dgrad_tf32",
         "conv2d_same_fwd_tf32": "conv2d_dgrad_tf32"}
#: the forward kernels, which fp32 serving launches
FORWARD_KERNELS = ("inorm_stats", "inorm_apply", "conv3d_same_fwd_tf32")
#: the 3^3 kernels of each route (tensor-core: bf16 at widths of multiples
#: of 8; TF32: fp32 there; CUDA-core: the rest)
TC_CONV_KERNELS = ("conv3d_same_fwd_tc", "conv3d_dgrad_tc", "conv3d_wgrad_tc")
TF32_CONV_KERNELS = ("conv3d_same_fwd_tf32", "conv3d_dgrad_tf32",
                     "conv3d_wgrad_tf32")
CORE_CONV_KERNELS = ("conv3d_same_fwd", "conv3d_dgrad", "conv3d_wgrad")
#: with ``conv_na``: the 20 preact InstanceNorm 3^3 convs of MedFormer-3D's
#: BasicBlocks (every conv that takes the 3^3 kernel) become fused ones;
#: fp32 serving launches the TF32 fused forward, the fp32 step the TF32
#: pair, the bf16 step the tensor-core pair
NA_FORWARD_KERNELS = ("inorm_stats", "inorm_apply", "conv3d_same_na_fwd_tf32")
NA_TC_KERNELS = ("conv3d_same_na_fwd_tc", "conv3d_wgrad_na_tc")
NA_TF32_KERNELS = ("conv3d_same_na_fwd_tf32", "conv3d_wgrad_na_tf32")
NA_CORE_KERNELS = ("conv3d_same_na_fwd", "conv3d_wgrad_na")
NA_CONVS = 20
#: every 3^3 kernel's launch counter
CONV3D_KERNELS = (TC_CONV_KERNELS + TF32_CONV_KERNELS + CORE_CONV_KERNELS
                  + NA_TC_KERNELS + NA_CORE_KERNELS + NA_TF32_KERNELS)
#: the TF32 kernels' largest error against an fp64 conv, at most this many
#: times cuDNN fp32's (TF32 off) at the same shape
F64_ERR_RATIO = 2.0

#: 3^3 conv shapes of the serving path (B, D, H, W, C, F): inc/up4 at
#: 128^3, down1/up3 at 64^3, down2/up2 at 32^3, plus a ragged shape, and
#: one of widths that are no multiples of 8 (bf16 takes the CUDA-core
#: route there)
CONV_CASES = [(2, 128, 128, 128, 32, 32), (2, 128, 128, 128, 96, 32),
              (2, 64, 64, 64, 64, 64), (2, 64, 64, 64, 192, 64),
              (2, 32, 32, 32, 128, 128), (2, 17, 23, 30, 24, 40),
              (2, 17, 23, 30, 20, 36)]
#: the conv case whose times go into the JSON record (up4's widest conv),
#: fp32; its dgrad (the forward kernel on flip-swapped weights) runs
#: 32 -> 96, and the dgrad of (2, 64^3, 192 -> 64) runs 64 -> 192
CONV_RECORD = (2, 128, 128, 128, 96, 32)
#: phase 3's NaN check: the fp32 case of widths of multiples of 8 that is
#: ragged in every dimension, and an interior voxel (b, d, h, w) of it, so
#: no 3^3 window around it crosses the SAME padding
NAN_CASE = (2, 17, 23, 30, 24, 40)
NAN_AT = (1, 8, 11, 15)
#: the fused preact conv's acts (AMOS serving: relu; the flagship: gelu),
#: and its JSON records: CONV_RECORD fp32 relu (AMOS serving's dtype and
#: act: the TF32 forward, the CUDA-core ones beside it) and bf16 gelu (the
#: flagship step's: the tensor-core pair)
NA_ACTS = ("relu", "gelu")
NA_RECORD = (CONV_RECORD, "float32", "relu")
NA_TC_RECORD = (CONV_RECORD, "bfloat16", "gelu")

#: 3x3 conv shapes (B, H, W, C, F) of the 2D paths at the ACDC recipe:
#: inc/up4 and down1/up3 at training batch 32, a 12-slice serving batch,
#: the channel envelope of the kernel dispatch, a ragged shape, and one of
#: widths that are no multiples of 8 (bf16 takes the CUDA-core route there)
CONV2D_CASES = [(32, 256, 256, 32, 32), (32, 128, 128, 64, 64),
                (12, 256, 256, 32, 32), (4, 64, 64, 192, 160),
                (3, 37, 50, 24, 40), (3, 37, 50, 20, 36)]
#: the 3x3 case of the JSON records: inc/up4 in the training step, in fp32
#: (the TF32 kernels, and the CUDA-core ones they replace) and bf16 (the
#: tensor-core kernels, and the CUDA-core ones beside them)
CONV2D_RECORD = (32, 256, 256, 32, 32)
#: the 3x3 kernels of each route (tensor-core: bf16 at widths of multiples
#: of 8; TF32: fp32 there; CUDA-core: the rest), forward, dgrad and wgrad
TC2D_KERNELS = ("conv2d_same_fwd_tc", "conv2d_dgrad_tc", "conv2d_wgrad_tc")
TF322D_KERNELS = ("conv2d_same_fwd_tf32", "conv2d_dgrad_tf32",
                  "conv2d_wgrad_tf32")
CORE2D_KERNELS = ("conv2d_same_fwd", "conv2d_dgrad", "conv2d_wgrad")
CONV2D_KERNELS = TC2D_KERNELS + TF322D_KERNELS + CORE2D_KERNELS
#: phase 3's 3x3 NaN check: a ragged fp32 case of widths of multiples of 8
#: and an interior pixel (b, h, w) of it
NAN2D_CASE = (2, 23, 30, 24, 40)
NAN2D_AT = (1, 11, 15)
#: the 3x3 convs of the ACDC MedFormer-2D on ``conv2d_kernel``: 2 in inc's
#: block, 4 in down1, 4 each in up3 and up4 (one forward, one dgrad and one
#: wgrad each a training step: no remat in 2D)
ACDC_CONVS = 14
#: depthwise 3x3 convs of MedFormer-2D's training step (B, H, W, C): the
#: B-MHA projections and MBConvs of down2/up2, down3/up1 and down4
DEPTHWISE2D_CASES = [(32, 64, 64, 128), (32, 64, 64, 256), (32, 32, 32, 512),
                     (32, 16, 16, 1024)]

#: window-attention shapes (B, H, N, D) of the Swin zoo (the JAX kernel's
#: header, window_attention.py:21-28): SwinUNETR's three stages of one
#: 128^3 window, VT-UNet's two, nnFormer's two; each with a padded token
#: grid and window whose half-window shift gives its region mask (nW
#: windows, nW dividing B)
WA_CASES = [((1000, 3, 343, 16), (70, 70, 70), (7, 7, 7)),
            ((125, 6, 343, 16), (35, 35, 35), (7, 7, 7)),
            ((27, 12, 343, 16), (21, 21, 21), (7, 7, 7)),
            ((343, 3, 343, 32), (49, 49, 49), (7, 7, 7)),
            ((64, 6, 343, 32), (28, 28, 28), (7, 7, 7)),
            ((200, 6, 64, 16), (20, 20, 32), (4, 4, 4)),
            ((16, 24, 512, 16), (16, 16, 32), (8, 8, 8))]
#: the case of the JSON record: SwinUNETR's first stage, shifted, fp32
WA_RECORD = ((1000, 3, 343, 16), True, "float32")
#: the shapes whose kernel, SDPA and plain times phase 3 takes: SwinUNETR's
#: three stages (its only path on the card; the other shapes are checked
#: and not timed, which keeps the script within its budget)
WA_TIMED = ((1000, 3, 343, 16), (125, 6, 343, 16), (27, 12, 343, 16))
#: the exponentials' bound beside the window attention's: the SFU's 16 a
#: clock on each of the 132 SMs at the H100 SXM's 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9
#: the window attention's error, held against max|o| (the scale of every
#: row's weighted mean of v): fp32, both sides sum N products per entry in
#: fp32 in other orders and exponentiate differently (exp2 of scaled
#: logits vs exp); bf16, both compute in fp32 and round once to bf16, one
#: ulp (2^-8 relative) where they straddle a rounding boundary.  A wrong
#: window, head, mask or tail errs by O(1) of max|o|.
WA_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}

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
# The fused preact conv's kernels take the conv's and the wgrad's
# tolerances: both versions round the normalised input to the storage type
# before it meets the weights or the gradient, so they differ only in the
# order of their fp32 sums.
#: phases 4 and 4c, probabilities of two fp32 forwards (card vs CPU)
MODEL_PROB_ATOL = 1e-4
#: phase 5b, the least share of voxels labelled alike by the fused and the
#: unfused fp32 route (same weights): they differ in the order of fp32 sums
#: only, so only near-ties of two classes' logits may flip
LABEL_AGREEMENT = 0.999
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
#: phase 4b, one bf16-autocast step on the card (the tensor-core kernels)
#: against the fp32 CPU step, same weights and batch.  bf16 rounds every
#: conv's and matmul's inputs and outputs (2^-8 relative), and this random
#: network's gradient is ill-conditioned (fp32 rounding alone moves it by
#: 2.2e-3 in L2, above): on an H100 the step with the tensor-core kernels
#: erred by 7.2e-6 in loss and 0.279 in gradient L2, and the same bf16 step
#: with every 3^3 conv on the CUDA-core kernels (which phase 4b also runs)
#: by 4.4e-6 and 0.279 (PERF.md): that is bf16's error here, not the
#: kernels'.  Held at about 1.4x (L2) and 14x (loss, a mean over 5e5
#: voxels) of it; a wrong tap, flip or tile errs by O(1) in both
STEP_BF16_LOSS_RTOL = 1e-4
STEP_BF16_GRAD_L2 = 0.4

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
#: (val_freq above epochs; phase 6v validates)
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
#: phase 6v: the flagship recipe on five 130^3 volumes, fold 0 of 5 (one
#: test volume), two steps, then the EMA model's evaluation by 128^3
#: sliding window: 8 windows (two a side: starts 0 and 2), 2 forwards at
#: the auto window batch of 4; the host distances, most of the phase,
#: scale with the volume (17-24 s of them at 160^3, 10.4 at 136^3)
FLAGSHIP_VAL = dict(
    FLAGSHIP, synthetic_cases=5, k_fold=5, synthetic_shape=[130, 130, 130],
    iter_per_epoch=2, epochs=1, val_freq=1, sliding_window=True,
    window_size=[128, 128, 128])
#: phase 4e: phase 4's small MedFormer-3D evaluated by a 64^3 sliding window
#: on one 72 x 64 x 80 Synthetic3D test volume (4 windows, clamped edges:
#: one forward at the auto window batch of 4)
SMALL_VAL = dict(
    SMALL, training_size=[64, 64, 64], sliding_window=True,
    window_size=[64, 64, 64], synthetic_cases=5, k_fold=5,
    synthetic_shape=[72, 64, 80])
#: phase 4e: the least share of voxels labelled alike by the card's and the
#: CPU's validation, and the largest difference of a class's Dice
VAL_LABEL_AGREEMENT = 0.999
VAL_DICE_ATOL = 1e-3
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

#: a narrow MedFormer-2D with the ACDC recipe's structure plus the JAX
#: default's conv blocks in down2/up2 (phase 4c), on the 3x3 kernel route
SMALL2D = dict(
    dataset="synthetic", model="medformer", dimension="2d", classes=4,
    in_chan=1, base_chan=16, map_size=2, conv_block="BasicBlock",
    conv_num=[2, 1, 0, 0, 0, 1, 2, 2], trans_num=[0, 1, 1, 1, 1, 1, 0, 0],
    num_heads=[1, 4, 4, 4, 4, 4, 1, 1], expansion=2, fusion_depth=2,
    fusion_dim=64, fusion_heads=4, proj_type="depthwise", aux_loss=True,
    conv2d_kernel=True)

#: a SwinUNETR at the BCV width (feature size 48: head dim 16 at every
#: stage), cut in input size (phase 4d)
SMALL_SWIN = dict(dataset="synthetic", model="swin_unetr", dimension="3d",
                  classes=14, in_chan=1, base_chan=48,
                  training_size=[64, 64, 64])
#: its inputs: 64^3 (padded windows, shifted masks at every stage, batch 2
#: so the mask's window index wraps at b % nW) and 32^3 (the last stage's
#: window shrinks to 4^3 and its bias-table index to [:64, :64])
SMALL_SWIN_SHAPES = [(2, 1, 64, 64, 64), (1, 1, 32, 32, 32)]

#: the model and inference keys of configs/bcv/swin_unetr_3d.yaml (phase 9)
BCV = dict(dataset="bcv", model="swin_unetr", dimension="3d", classes=14,
           in_chan=1, base_chan=48, training_size=[128, 128, 128],
           sliding_window=True, window_size=[128, 128, 128])
#: window-attention launches per SwinUNETR forward: one per Swin block,
#: depths (2, 2, 2, 0)
SWIN_BLOCKS = 6

#: the model and inference keys of configs/acdc/medformer_2d.yaml, on the
#: 3x3 kernel route (``conv2d_kernel``; phases 7 and 8; phase 8b turns it
#: off, the default)
ACDC = dict(
    dataset="acdc", model="medformer", dimension="2d", classes=4, in_chan=1,
    base_chan=32, conv_block="BasicBlock", map_size=3,
    conv_num=[2, 0, 0, 0, 0, 0, 2, 2], trans_num=[0, 2, 2, 2, 2, 2, 0, 0],
    num_heads=[1, 4, 8, 16, 8, 4, 1, 1], expansion=2, fusion_depth=2,
    fusion_dim=512, fusion_heads=16, attn_drop=0.0, proj_drop=0.0,
    proj_type="depthwise", aux_loss=True, training_size=[256, 256],
    conv2d_kernel=True)
#: two cine-MR requests (z, y, x shape, z, y, x spacing) at the target
#: in-plane spacing 1.5625 mm: one on it (224 x 240, padded to 258^2: four
#: overlapping 256^2 windows), one resampled from 1.25 mm to 16 x 304 x 336
#: (four windows)
REQUESTS_2D = [((10, 224, 240), (10.0, 1.5625, 1.5625)),
               ((16, 380, 420), (10.0, 1.25, 1.25))]
TARGET_SPACING_2D = "1.5625,1.5625"

#: the ACDC training recipe (configs/acdc/medformer_2d.yaml: 4 classes,
#: 256^2 crops, affine pad 32, AdamW 5e-4 wd 0.05, EMA 0.99, aux loss
#: [0.5, 0.5], class weights [0.5, 1, 1, 1]) on Synthetic2D: 40 cases of
#: 6 x 320^2, of which fold 0 trains on 32, 192 slices: one epoch of 6
#: steps at batch 32; validation off (phase 8v validates)
ACDC_TRAIN = dict(
    ACDC, dataset="synthetic", aux_weight=[0.5, 0.5],
    weight=[0.5, 1.0, 1.0, 1.0], rlt=1, optimizer="adamw", base_lr=5e-4,
    betas=[0.9, 0.999], weight_decay=0.05, ema=True, ema_alpha=0.99,
    scale=0.3, rotate=180, translate=0, affine_pad_size=[32, 32],
    gaussian_noise_std=0.02, synthetic_cases=40, k_fold=5, split_seed=0,
    epochs=1, print_freq=1, val_freq=2)
TRAIN2D_BATCH = 32
#: phase 8v: the ACDC recipe on 10 cases, fold 0 of 5 (48 slices: one step
#: at batch 32), then the EMA model's evaluation of the 2 test volumes (6
#: slices each, centre-cropped to 256^2: one whole-image forward a volume)
ACDC_VAL = dict(ACDC_TRAIN, synthetic_cases=10, val_freq=1)

#: phase 6k: configs/kits/medformer_3d.yaml as shipped (MedFormer-3D, base
#: 32, ReLU, 3 classes, 128^3 crops, remat, the KiTS recipe with its 60-voxel
#: affine pad), read by the port's ``load_config``, trained in fp32 (the
#: CLI's default, no ``--amp``) at batch 2 for KITS_STEPS steps on
#: KITS_CASES written HU-like cases of about 1.25x the crop, fold 0 of 5;
#: the yaml's val_freq (20) is above the one epoch, so validation stays off.
#: It feeds the card from host windows (``device_cache: false``): the 210
#: KiTS cases at 0.78 mm are far above the cache's 4 GB, so that is the path
#: a user's corpus takes under ``auto``, where these 5 cases would fit
KITS_CASES = [((160, 160, 160), (0.78, 0.78, 0.78)),
              ((150, 170, 160), (0.78, 0.78, 0.78)),
              ((170, 150, 165), (0.78, 0.78, 0.78)),
              ((160, 165, 150), (0.78, 0.78, 0.78)),
              ((155, 160, 170), (0.78, 0.78, 0.78))]
KITS_STEPS = WARMUP_STEPS + 4
#: phase 6kn: the same recipe with ``conv_na: true``, every one of its 16
#: kernel convs a fused preact conv; fewer steps (the median of the 2
#: after warm-up) to keep the script within its time
KITS_NA_STEPS = WARMUP_STEPS + 2
#: the KiTS MedFormer-3D's 3^3 convs on the kernel route (ConvNormAct 3^3,
#: C_in <= 192, C_out <= 128): 2 in inc, 4 in down1, 5 in up3, 5 in up4,
#: every width a multiple of 8.  A fp32 step launches, per conv, two
#: ``conv3d_same_fwd_tf32`` (the forward and remat's recompute), one
#: ``conv3d_dgrad_tf32`` and one ``conv3d_wgrad_tf32``
KITS_CONVS = 16
#: phase 6a: configs/acdc/medformer_3d.yaml (16 x 192 x 192 crops, 4
#: classes, its full_volume recipe), fp32, batch 2, ACDC3D_STEPS steps on 6
#: written cases of two cine-MR frames each (fold 0 of 5: 10 training
#: volumes), on the device cache's full-volume path
ACDC3D_CASES = [((10, 232, 216), (10.0, 1.5625, 1.5625)),
                ((9, 208, 256), (10.0, 1.5625, 1.5625)),
                ((12, 240, 240), (10.0, 1.5625, 1.5625)),
                ((8, 224, 270), (10.0, 1.5625, 1.5625)),
                ((11, 216, 200), (10.0, 1.5625, 1.5625)),
                ((10, 256, 232), (10.0, 1.5625, 1.5625))]
ACDC3D_STEPS = WARMUP_STEPS + 4
#: phases 6k and 6a: batches timed alone after the run (the data path's
#: cost a step, beside the step that the trainer overlaps it with)
DATA_BATCHES = 3
#: phase 3a: the augmentation ops on the card against the same ops on the
#: CPU with the same drawn scalars: the image within AUG_TOL of max|ref|
#: (both sum in fp32 in other orders; the blur's taps are explicit fp32
#: sums, so a TF32 convolution would show here at about 1e-3), the labels
#: equal
AUG_TOL = 1e-5

#: phase 10's JSON records: the copy-scale's 16-byte, 2048-element case
#: (its library call: ``x * 2`` on the 128-wide view), the weight-stationary
#: dot (cuBLAS beside it), the square dot, and the ladder's full rung at the
#: production tile on bf16 (2, 128^3, 96 -> 32) (cuDNN beside it)
COPY_RECORD, DOT_RECORD, LADDER_RECORD = "vec2k", "stationary", "bf16_96"
#: the probe dots' bf16 outputs against their fp32 plain versions cast to
#: bf16: both sum in fp32 in other orders and round once, so they differ by
#: at most one bf16 ulp of an output, 2^-7 of its magnitude (of max|ref| at
#: most: 3.1e-2 at 6.25, an output in [4, 8)); a wrong fragment or tile
#: errs by O(1).  ``probe_dot_t``'s plain version runs on DOT_CHECK_TILES
#: tiles, the first and last halves (its whole fp32 output is 6 GB)
PROBE_TOL = 2 ** -7
DOT_CHECK_TILES = 64


#: the script's start (phase headers print the seconds since)
T0 = time.perf_counter()


def say(msg: str) -> None:
    if msg.startswith("[phase"):
        msg = f"{msg} (at {time.perf_counter() - T0:.1f} s)"
    print(msg, flush=True)


def iters_for(flops_or_bytes: float, per_ms: float) -> int:
    """Enough calls for ~50 ms of work, at least 3."""
    return max(3, min(200, int(50 * per_ms / max(flops_or_bytes, 1.0))))


def plain_iters(n: int) -> int:
    """The repeats of a plain version timed beside a kernel timed ``n``
    times: a quarter, at least 1 (the plain versions of the fused pair and
    the window attention run 3-10x longer than their kernels)."""
    return max(1, n // 4)


def entry(ms, plain_ms, library_ms, flops, nbytes, dtype, shape,
          tf32x3: bool = False) -> dict:
    """One kernel's timed record, with its bound; ``tf32x3``: an fp32
    kernel whose bound is three TF32 tensor-core passes over ``flops``."""
    if tf32x3:
        b_ms, b_by = bound_ms(3 * flops, nbytes, "tf32")
    else:
        b_ms, b_by = bound_ms(flops, nbytes, dtype)
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": b_ms, "bound_by": b_by, "dtype": dtype,
           "shape": list(shape)}
    if tf32x3:
        rec["bound_as"] = "3 TF32 passes at the TF32 peak"
    return rec


def ptxas_report(log: str, key: str) -> dict:
    """{kernel: "N regs, S/L spill bytes"} from nvcc's ``-Xptxas -v``
    output for the entry functions whose mangled name contains ``key``
    (template arguments shown as <a,b>)."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            # the identifier after its length prefix
            short = re.search(r"\d(conv\w*?_kernel)", name)
            args = [a.replace("n", "-")
                    for a in re.findall(r"Li(n?\d+)E", name)]
            name = (short.group(1) if short else name) + \
                (f"<{','.join(args)}>" if args else "")
            continue
        if name is None or key not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name] = f"spill {m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name] = f"{m.group(1)} regs, " + out.get(name, "")
    return out


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


def conv64(x, w):
    """The SAME 3^3 (x[B, D, H, W, C]) or 3x3 (x[B, H, W, C]) conv of
    channels-last x in fp64 on x's device (the reference of the TF32
    kernels' and cuDNN fp32's errors)."""
    import torch.nn.functional as F
    if x.dim() == 4:
        y = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), padding=1)
        return y.permute(0, 2, 3, 1)
    y = F.conv3d(x.double().permute(0, 4, 1, 2, 3), w.double(), padding=1)
    return y.permute(0, 2, 3, 4, 1)


def wgrad64(x, g):
    """The SAME 3^3 conv's weight gradient in fp64 on x's device, torch's
    [F, C, 3, 3, 3] (the reference of the TF32 wgrad's and cuDNN fp32's
    errors)."""
    import torch
    return torch.nn.grad.conv3d_weight(
        x.double().permute(0, 4, 1, 2, 3), (g.shape[-1], x.shape[-1], 3, 3, 3),
        g.double().permute(0, 4, 1, 2, 3), padding=1)


def f64_errors(name, out, ref32, ref64, into: dict | None = None) -> str:
    """Assert that a TF32 kernel's largest error against the fp64 result is
    at most F64_ERR_RATIO times cuDNN fp32's (``ref32``, TF32 off), and
    describe both, relative to max|ref|; ``into`` takes both numbers."""
    scale = float(ref64.abs().max())
    e_k = float((out.double() - ref64).abs().max()) / scale
    e_c = float((ref32.double() - ref64).abs().max()) / scale
    assert e_k <= F64_ERR_RATIO * e_c, \
        f"{name}: {e_k:.3e} of max|ref| from fp64, cuDNN fp32 {e_c:.3e}"
    if into is not None:
        into.update(f64_err=e_k, cudnn_f64_err=e_c)
    return f" vs fp64: kernel {e_k:.3e} cuDNN fp32 {e_c:.3e} of max|ref|"


def phase_kernels(device, conv_cases, norm_cases, record: dict) -> None:
    """Phase 3: each kernel against its plain version on ``device``.  Each
    3^3 conv case asserts the route ``conv3d_route`` gives it (the launch
    counter that moved) and prints cuDNN's time; where a case takes the
    tensor-core or TF32 route the CUDA-core kernel it replaces is held and
    timed too, and the TF32 kernel's error against an fp64 conv is held
    against cuDNN fp32's."""
    import torch
    import torch.nn.functional as F
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
            scale = float(ref.float().abs().max())
            route = conv3d.conv3d_route(dtype, C, Fo)
            key = conv3d.FORWARD_KEYS[route][0]
            before = conv3d.launches[key]
            out = conv3d.conv3d_same(x, w)
            torch.cuda.synchronize()
            assert conv3d.launches[key] == before + 1, \
                f"{dt} {case} did not take the {key} route"
            err = float((out.float() - ref.float()).abs().max())
            f64 = ""
            if route == conv3d.TF32X3:
                f64 = f64_errors(f"{key} {case}", out, ref, conv64(x, w))
            flops = 2 * 27 * C * Fo * B * D * H * W
            n = iters_for(flops, 1e10)
            ms = cuda_ms(lambda: conv3d.conv3d_same(x, w), n)
            plain_ms = cuda_ms(lambda: conv3d.conv3d_same_plain(x, w), n)
            xc = x.permute(0, 4, 1, 2, 3)              # NCDHW view, no copy
            lib_ms = cuda_ms(lambda: F.conv3d(xc, w, padding=1), n)
            core = ""
            if route != conv3d.CUDA_CORE:
                # the CUDA-core kernel the tensor-core one replaces
                core_out = conv3d._launch_fwd(x, w, "conv3d_same_fwd")
                torch.cuda.synchronize()
                core_err = float((core_out.float() - ref.float()).abs().max())
                assert core_err <= CONV_TOL[dt] * scale, \
                    f"conv3d_same_fwd {dt} {case}: {core_err:.3e}"
                errs["conv3d_same_fwd"] = max(errs["conv3d_same_fwd"],
                                              core_err)
                core_ms = cuda_ms(
                    lambda: conv3d._launch_fwd(x, w, "conv3d_same_fwd"), n)
                core = f" CUDA-core {core_ms:.3f} ms ({core_ms / ms:.2f}x)"
                del core_out
            say(f"  {key:20s} {dt:8s} {case}: max_abs_err {err:.3e} "
                f"max_rel_err {err / scale:.3e} of max|ref| {scale:.3f} "
                f"(tol {CONV_TOL[dt]:.1e}){f64} "
                f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s) "
                f"plain {plain_ms:.3f} ms cuDNN {lib_ms:.3f} ms "
                f"({ms / lib_ms:.2f}x){core}")
            assert err <= CONV_TOL[dt] * scale, \
                f"{key} {dt} {case}: max abs err {err:.3e}"
            errs[key] = max(errs[key], err)
            if case == CONV_RECORD:
                nbytes = (x.numel() + w.numel() + ref.numel()) * x.element_size()
                if dt == "float32":
                    record["conv3d_same_fwd"] = entry(core_ms, plain_ms,
                                                      lib_ms, flops, nbytes,
                                                      dt, case)
                    record["conv3d_same_fwd_tf32"] = entry(
                        ms, plain_ms, lib_ms, flops, nbytes, dt, case,
                        tf32x3=True)
                else:
                    record["conv3d_same_fwd"][dt] = entry(
                        core_ms, plain_ms, lib_ms, flops, nbytes, dt, case)
                    record["conv3d_same_fwd_tc"] = entry(
                        ms, plain_ms, lib_ms, flops, nbytes, dt, case)
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
                # no single PyTorch call computes the stats or the apply
                # with an activation alone; F.instance_norm computes both
                # without one, timed for reference
                xc = x.transpose(1, 2)
                in_ms = cuda_ms(lambda: F.instance_norm(xc, eps=eps), n)
                say(f"  F.instance_norm (stats + apply, no act) {dt} "
                    f"B={B} S={S} C={C}: {in_ms:.3f} ms")
                n_el = x.numel()
                record["inorm_stats"] = entry(
                    st_ms, st_plain, None, 3 * n_el, nbytes + 2 * B * C * 4,
                    dt, (B, S, C))
                record["inorm_apply"] = entry(
                    ap_ms, ap_plain, None, 3 * n_el,
                    2 * nbytes + 2 * B * C * 4, dt, (B, S, C))
            del x, y, py
    record["errors"] = errs
    torch.cuda.synchronize()


def phase_backward_kernels(device, conv_cases, norm_cases, record: dict) -> None:
    """Phase 3, backward: dgrad, wgrad and the norm backward against their
    plain versions on ``device``, with cuDNN's call beside each conv
    kernel (``F.conv3d`` on the flip-swapped weights, ``conv3d_weight``)
    and, where a case takes the tensor-core or TF32 route, the CUDA-core
    kernel each replaces; the TF32 dgrad's and wgrad's errors against an
    fp64 conv or weight gradient are held against cuDNN fp32's (TF32 off,
    as phase_kernels set it: ``conv3d_wgrad_plain`` is cuDNN's fp32
    ``conv3d_weight``)."""
    import torch
    import torch.nn.functional as F
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
            ws = conv3d.flip_swap(w)
            route = conv3d.conv3d_route(dtype, C, Fo)
            kf, kx = conv3d.FORWARD_KEYS[route][:2]
            kw = {conv3d.TENSOR_CORE: "conv3d_wgrad_tc",
                  conv3d.TF32X3: "conv3d_wgrad_tf32"}.get(route,
                                                          "conv3d_wgrad")
            before = (conv3d.launches[kx], conv3d.launches[kw])
            dx = conv3d.conv3d_dgrad(g, w)
            ref_dx = conv3d.conv3d_same_plain(g, ws)
            dw = conv3d.conv3d_wgrad(x, g)
            ref_dw = conv3d.conv3d_wgrad_plain(x, g)
            torch.cuda.synchronize()
            assert (conv3d.launches[kx], conv3d.launches[kw]) == \
                (before[0] + 1, before[1] + 1), f"{dt} {case}: not {kx}, {kw}"
            sx = float(ref_dx.float().abs().max())
            ex = float((dx.float() - ref_dx.float()).abs().max())
            sw = float(ref_dw.abs().max())
            ew = float((dw - ref_dw).abs().max())
            f64 = f64_w = ""
            f64_rec: dict = {}
            if route == conv3d.TF32X3:
                f64 = f64_errors(f"{kx} {case}", dx, ref_dx, conv64(g, ws))
                f64_w = f64_errors(f"{kw} {case}", dw, ref_dw,
                                   wgrad64(x, g), f64_rec)
            flops = 2 * 27 * C * Fo * B * D * H * W
            n = iters_for(flops, 1e10)
            xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            dx_ms = cuda_ms(lambda: conv3d.conv3d_dgrad(g, w), n)
            dx_plain = cuda_ms(lambda: conv3d.conv3d_same_plain(g, ws), n)
            dx_lib = cuda_ms(lambda: F.conv3d(gc, ws, padding=1), n)
            dw_ms = cuda_ms(lambda: conv3d.conv3d_wgrad(x, g), n)
            dw_plain = cuda_ms(lambda: conv3d.conv3d_wgrad_plain(x, g), n)
            dw_lib = cuda_ms(lambda: torch.nn.grad.conv3d_weight(
                xc, w.shape, gc, padding=1), n)
            core_x = core_w = ""
            if route != conv3d.CUDA_CORE:
                # the CUDA-core dgrad the tensor-core or TF32 one replaces
                cx = conv3d._launch_fwd(g, ws, "conv3d_dgrad")
                torch.cuda.synchronize()
                cex = float((cx.float() - ref_dx.float()).abs().max())
                assert cex <= CONV_TOL[dt] * sx, f"conv3d_dgrad {dt} {case}"
                errs["conv3d_same_fwd"] = max(errs["conv3d_same_fwd"], cex)
                cx_ms = cuda_ms(
                    lambda: conv3d._launch_fwd(g, ws, "conv3d_dgrad"), n)
                core_x = f" CUDA-core {cx_ms:.3f} ms ({cx_ms / dx_ms:.2f}x)"
                del cx
                # and the CUDA-core wgrad
                cw = conv3d._launch_wgrad(x, g)
                torch.cuda.synchronize()
                cew = float((cw - ref_dw).abs().max())
                assert cew <= WGRAD_TOL * sw, f"conv3d_wgrad {dt} {case}"
                errs["conv3d_wgrad"] = max(errs["conv3d_wgrad"], cew)
                cw_ms = cuda_ms(lambda: conv3d._launch_wgrad(x, g), n)
                core_w = f" CUDA-core {cw_ms:.3f} ms ({cw_ms / dw_ms:.2f}x)"
                del cw
            say(f"  {kx:20s} {dt:8s} {case}: max_abs_err {ex:.3e} "
                f"max_rel_err {ex / sx:.3e} (tol {CONV_TOL[dt]:.1e}){f64} "
                f"kernel {dx_ms:.3f} ms ({flops / dx_ms / 1e9:.1f} TFLOP/s) "
                f"plain {dx_plain:.3f} ms cuDNN {dx_lib:.3f} ms "
                f"({dx_ms / dx_lib:.2f}x){core_x}")
            say(f"  {kw:20s} {dt:8s} {case}: max_abs_err {ew:.3e} "
                f"max_rel_err {ew / sw:.3e} of max|dW| {sw:.1f} "
                f"(tol {WGRAD_TOL:.1e}){f64_w} kernel {dw_ms:.3f} ms "
                f"({flops / dw_ms / 1e9:.1f} TFLOP/s) plain {dw_plain:.3f} ms "
                f"cuDNN {dw_lib:.3f} ms ({dw_ms / dw_lib:.2f}x){core_w}")
            assert ex <= CONV_TOL[dt] * sx, f"{kx} {dt} {case}: {ex:.3e}"
            assert ew <= WGRAD_TOL * sw, f"{kw} {dt} {case}: {ew:.3e}"
            errs[kf] = max(errs[kf], ex)
            errs[kw] = max(errs[kw], ew)
            if case == CONV_RECORD:
                nbytes = (x.numel() + g.numel()) * x.element_size() \
                    + 27 * C * Fo * 4
                if dt == "float32":
                    record["conv3d_wgrad"] = entry(cw_ms, dw_plain, dw_lib,
                                                   flops, nbytes, dt, case)
                    record["conv3d_wgrad_tf32"] = dict(
                        entry(dw_ms, dw_plain, dw_lib, flops, nbytes, dt,
                              case, tf32x3=True), **f64_rec)
                    record["conv3d_dgrad"] = (cx_ms, dx_plain, dx_lib)
                    record["conv3d_dgrad_tf32"] = (dx_ms, dx_plain, dx_lib)
                else:
                    record["conv3d_wgrad"][dt] = entry(
                        cw_ms, dw_plain, dw_lib, flops, nbytes, dt, case)
                    record["conv3d_dgrad_" + dt] = (cx_ms, dx_plain, dx_lib)
                    record["conv3d_wgrad_tc"] = entry(
                        dw_ms, dw_plain, dw_lib, flops, nbytes, dt, case)
                    record["conv3d_dgrad_tc"] = (dx_ms, dx_plain, dx_lib)
            del x, g, w, ws, dx, ref_dx, dw, ref_dw
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
                n_el, stat_bytes = x.numel(), 2 * B * C * 4
                record["inorm_bwd_stats"] = entry(
                    st_ms, st_plain, None, 6 * n_el,
                    2 * nbytes + 2 * stat_bytes, dt, (B, S, C))
                record["inorm_bwd_apply"] = entry(
                    ap_ms, ap_plain, None, 8 * n_el,
                    3 * nbytes + 2 * stat_bytes, dt, (B, S, C))
            del x, dy, dx, pdx
    torch.cuda.synchronize()


def phase_na_kernels(device, conv_cases, record: dict) -> None:
    """Phase 3, the fused preact conv: the forward and weight-gradient
    kernels of the route ``conv3d_route`` gives each case (the launch
    counters that moved: at widths of multiples of 8 in bf16
    ``conv3d_same_na_fwd_tc`` and ``conv3d_wgrad_na_tc``, in fp32
    ``conv3d_same_na_fwd_tf32`` and ``conv3d_wgrad_na_tf32``, else
    ``conv3d_same_na_fwd`` and ``conv3d_wgrad_na``) against their plain
    versions (``inorm_apply_plain`` then the plain conv or weight gradient),
    on inputs of mean 1.5 so that a padding normalised to act(-mean * rstd)
    instead of 0 fails.  Each is timed beside the unfused pair of kernels it
    replaces (``inorm_apply`` + ``conv3d_same``, ``inorm_apply`` +
    ``conv3d_wgrad``, on the same route); where a case takes the
    tensor-core or TF32 route the CUDA-core fused kernels it replaces (the
    forward and the wgrad) are held and timed too, in fp32 with the
    CUDA-core unfused forward pair, and the TF32 kernels' errors against an
    fp64 conv and weight gradient are held against cuDNN fp32's.  No single
    PyTorch call computes either function."""
    import torch
    from cbim_tpu_torch.ops.kernels import conv3d, fused_norm
    gen = torch.Generator(device=device).manual_seed(6)
    errs = record["errors"]
    errs.update({k: 0.0 for k in NA_TC_KERNELS + NA_CORE_KERNELS
                 + NA_TF32_KERNELS})
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for case in conv_cases:
            B, D, H, W, C, Fo = case
            x = torch.randn(B, D, H, W, C, generator=gen, device=device)
            g = torch.randn(B, D, H, W, Fo, generator=gen, device=device)
            w = torch.randn(Fo, C, 3, 3, 3, generator=gen, device=device)
            x, g = (x * 2 + 1.5).to(dtype), g.to(dtype)
            w = (w / math.sqrt(27 * C)).to(dtype)
            x3 = x.view(B, -1, C)
            mean, rstd = fused_norm.inorm_stats_plain(x3, 1e-4)
            route = conv3d.conv3d_route(dtype, C, Fo)
            tc = route == conv3d.TENSOR_CORE
            kf = conv3d.FORWARD_KEYS[route][2]
            kw = {conv3d.TENSOR_CORE: "conv3d_wgrad_na_tc",
                  conv3d.TF32X3: "conv3d_wgrad_na_tf32",
                  conv3d.CUDA_CORE: "conv3d_wgrad_na"}[route]
            # the prologue's subtract, multiply and act once per input
            flops = 2 * 27 * C * Fo * B * D * H * W + 3 * x.numel()
            n = iters_for(flops, 1e10)
            for act in NA_ACTS:
                def normed():
                    return fused_norm.inorm_apply(x3, mean, rstd,
                                                  act).view(x.shape)

                na = (mean, rstd, act)
                before = (conv3d.launches[kf], conv3d.launches[kw])
                y = conv3d.conv3d_same_na(x, mean, rstd, w, act)
                dw = conv3d.conv3d_wgrad_na(x, mean, rstd, g, act)
                torch.cuda.synchronize()
                assert (conv3d.launches[kf], conv3d.launches[kw]) == \
                    (before[0] + 1, before[1] + 1), \
                    f"{dt} {case} {act}: not {kf}, {kw}"
                ref_y = conv3d.conv3d_same_na_plain(x, mean, rstd, w, act)
                ref_dw = conv3d.conv3d_wgrad_na_plain(x, mean, rstd, g, act)
                sy = float(ref_y.float().abs().max())
                ey = float((y.float() - ref_y.float()).abs().max())
                sw = float(ref_dw.abs().max())
                ew = float((dw - ref_dw).abs().max())
                f64, f64_wg, f64_rec = "", "", {}
                if route == conv3d.TF32X3:
                    xn = conv3d._normed(x, mean, rstd, act)
                    f64 = f64_errors(f"{kf} {case} {act}", y, ref_y,
                                     conv64(xn, w))
                    f64_wg = f64_errors(f"{kw} {case} {act}", dw, ref_dw,
                                        wgrad64(xn, g), f64_rec)
                    del xn
                t_fwd = (
                    cuda_ms(lambda: conv3d.conv3d_same_na(x, mean, rstd, w,
                                                          act), n),
                    cuda_ms(lambda: conv3d.conv3d_same(normed(), w), n),
                    cuda_ms(lambda: conv3d.conv3d_same_na_plain(
                        x, mean, rstd, w, act), plain_iters(n)))
                t_wg = (
                    cuda_ms(lambda: conv3d.conv3d_wgrad_na(x, mean, rstd, g,
                                                           act), n),
                    cuda_ms(lambda: conv3d.conv3d_wgrad(normed(), g), n),
                    cuda_ms(lambda: conv3d.conv3d_wgrad_na_plain(
                        x, mean, rstd, g, act), plain_iters(n)))
                core = {}
                if route != conv3d.CUDA_CORE:
                    # the CUDA-core fused forward and wgrad the tensor-core
                    # or TF32 ones replace
                    cy = conv3d._launch_fwd(x, w, "conv3d_same_na_fwd", na)
                    cw = conv3d._launch_wgrad(x, g, na)
                    torch.cuda.synchronize()
                    cey = float((cy.float() - ref_y.float()).abs().max())
                    cew = float((cw - ref_dw).abs().max())
                    assert cey <= CONV_TOL[dt] * sy, \
                        f"conv3d_same_na_fwd {dt} {case} {act}: {cey:.3e}"
                    assert cew <= WGRAD_TOL * sw, \
                        f"conv3d_wgrad_na {dt} {case} {act}: {cew:.3e}"
                    errs["conv3d_same_na_fwd"] = max(
                        errs["conv3d_same_na_fwd"], cey)
                    errs["conv3d_wgrad_na"] = max(errs["conv3d_wgrad_na"],
                                                  cew)
                    core[kf] = cuda_ms(lambda: conv3d._launch_fwd(
                        x, w, "conv3d_same_na_fwd", na), n)
                    core[kw] = cuda_ms(lambda: conv3d._launch_wgrad(
                        x, g, na), n)
                    del cy, cw
                core_pair = ""
                if route == conv3d.TF32X3:
                    # the unfused pair on the CUDA-core conv, as served
                    # before the TF32 route
                    core["pair"] = cuda_ms(lambda: conv3d._launch_fwd(
                        normed(), w, "conv3d_same_fwd"), n)
                    core_pair = (f" CUDA-core unfused pair "
                                 f"{core['pair']:.3f} ms")
                for key, (ms, pair_ms, plain_ms), err, scale, tol, ef in (
                        (kf, t_fwd, ey, sy, CONV_TOL[dt], f64 + core_pair),
                        (kw, t_wg, ew, sw, WGRAD_TOL, f64_wg)):
                    extra = (f" CUDA-core {core[key]:.3f} ms "
                             f"({core[key] / ms:.2f}x)" if key in core else "")
                    say(f"  {key:23s} {dt:8s} {case} {act}: max_abs_err "
                        f"{err:.3e} max_rel_err {err / scale:.3e} of max|ref| "
                        f"{scale:.3f} (tol {tol:.1e}){ef} kernel {ms:.3f} ms "
                        f"({flops / ms / 1e9:.1f} TFLOP/s) unfused pair "
                        f"{pair_ms:.3f} ms ({ms / pair_ms:.2f}x) plain "
                        f"{plain_ms:.3f} ms{extra}")
                    assert err <= tol * scale, f"{key} {dt} {case} {act}"
                    errs[key] = max(errs[key], err)
                if (case, dt, act) in (NA_RECORD, NA_TC_RECORD):
                    size, stat_bytes = x.element_size(), 2 * B * C * 4
                    fwd_bytes = (x.numel() + w.numel() + y.numel()) * size \
                        + stat_bytes
                    fwd = entry(t_fwd[0], t_fwd[2], None, flops, fwd_bytes,
                                dt, case, tf32x3=route == conv3d.TF32X3)
                    wg_bytes = (x.numel() + g.numel()) * size \
                        + dw.numel() * 4 + stat_bytes
                    wg = entry(t_wg[0], t_wg[2], None, flops, wg_bytes, dt,
                               case, tf32x3=route == conv3d.TF32X3)
                    record[kf] = dict(fwd, act=act, unfused_ms=t_fwd[1])
                    record[kw] = dict(wg, act=act, unfused_ms=t_wg[1],
                                      **f64_rec)
                    if route != conv3d.CUDA_CORE:
                        record[kf]["cuda_core_ms"] = core[kf]
                        record[kw]["cuda_core_ms"] = core[kw]
                    if route == conv3d.TF32X3:
                        # the CUDA-core fused pair it replaces, and the
                        # CUDA-core unfused forward pair
                        record["conv3d_same_na_fwd"] = dict(entry(
                            core[kf], t_fwd[2], None, flops, fwd_bytes, dt,
                            case), act=act, unfused_ms=core["pair"])
                        record["conv3d_wgrad_na"] = dict(entry(
                            core[kw], t_wg[2], None, flops, wg_bytes, dt,
                            case), act=act, unfused_ms=t_wg[1])
                del y, ref_y, dw, ref_dw
            del x, g, w, x3
    torch.cuda.synchronize()


def phase_nan(device) -> None:
    """Phase 3, NaN: the card's NaN (0x7FFFFFFF, what its arithmetic makes)
    in one channel of the voxel NAN_AT of x and of g, fp32 at NAN_CASE,
    through the TF32 forward, dgrad, fused forward (ReLU), wgrad and fused
    wgrad (ReLU) and ``inorm_apply`` (ReLU); and at the pixel NAN2D_AT,
    fp32 at NAN2D_CASE, through the 3x3 TF32 forward, dgrad and wgrad.  Each output must be NaN
    exactly where that value enters it (torch's rule, which the plain
    versions follow) and finite elsewhere: a conv's in every output channel
    of the 3^3 voxels (3x3 pixels) around the NaN; the wgrad's where the
    plain weight gradient of the NaNs' indicators against ones is nonzero;
    the apply's at the NaN alone.  The plain versions' own NaN counts are
    printed beside."""
    import torch
    import torch.nn.functional as F
    from cbim_tpu_torch.ops.kernels import conv2d, conv3d, fused_norm
    gen = torch.Generator(device=device).manual_seed(9)
    B, D, H, W, C, Fo = NAN_CASE
    x = torch.randn(B, D, H, W, C, generator=gen, device=device)
    g = torch.randn(B, D, H, W, Fo, generator=gen, device=device)
    w = torch.randn(Fo, C, 3, 3, 3, generator=gen, device=device)
    w = w / math.sqrt(27 * C)
    mean, rstd = fused_norm.inorm_stats_plain(x.view(B, -1, C), 1e-5)
    nan = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    x[(*NAN_AT, C // 2)] = nan
    g[(*NAN_AT, Fo // 2)] = nan

    def around(t):
        """every channel of the 3^3 voxels around t's NaNs"""
        m = t.isnan().any(-1).float()[:, None]
        return F.max_pool3d(m, 3, stride=1, padding=1)[:, 0, ..., None] > 0

    def wgrad_mask(x, g):
        """where x's or g's NaNs enter a product (> 0.5: cuDNN's sums of
        ones and zeros need not be exact)"""
        return conv3d.conv3d_wgrad_plain(x.isnan().float(), torch.ones_like(g)) \
            + conv3d.conv3d_wgrad_plain(torch.ones_like(x),
                                        g.isnan().float()) > 0.5

    keys = ("conv3d_same_fwd_tf32", "conv3d_dgrad_tf32",
            "conv3d_same_na_fwd_tf32", "conv3d_wgrad_tf32",
            "conv3d_wgrad_na_tf32", "inorm_apply")
    before = {k: {**conv3d.launches, **fused_norm.launches}[k] for k in keys}
    outs = {
        "conv3d_same_fwd_tf32": (conv3d.conv3d_same(x, w),
                                 conv3d.conv3d_same_plain(x, w), around(x)),
        "conv3d_dgrad_tf32": (conv3d.conv3d_dgrad(g, w),
                              conv3d.conv3d_same_plain(g, conv3d.flip_swap(w)),
                              around(g)),
        "conv3d_same_na_fwd_tf32": (
            conv3d.conv3d_same_na(x, mean, rstd, w, "relu"),
            conv3d.conv3d_same_na_plain(x, mean, rstd, w, "relu"), around(x)),
        "conv3d_wgrad_tf32": (conv3d.conv3d_wgrad(x, g),
                              conv3d.conv3d_wgrad_plain(x, g),
                              wgrad_mask(x, g)),
        "conv3d_wgrad_na_tf32": (
            conv3d.conv3d_wgrad_na(x, mean, rstd, g, "relu"),
            conv3d.conv3d_wgrad_na_plain(x, mean, rstd, g, "relu"),
            wgrad_mask(x, g)),
        "inorm_apply": (
            fused_norm.inorm_apply(x.view(B, -1, C), mean, rstd, "relu"),
            fused_norm.inorm_apply_plain(x.view(B, -1, C), mean, rstd, "relu"),
            x.view(B, -1, C).isnan()),
    }
    torch.cuda.synchronize()
    after = {**conv3d.launches, **fused_norm.launches}
    assert all(after[k] == before[k] + 1 for k in keys), \
        f"NaN check: not every kernel launched once: {before} -> {after}"
    at = {k: (NAN_CASE, NAN_AT) for k in outs}

    # the 3x3 TF32 kernels
    B, H, W, C, Fo = NAN2D_CASE
    x2 = torch.randn(B, H, W, C, generator=gen, device=device)
    g2 = torch.randn(B, H, W, Fo, generator=gen, device=device)
    w2 = torch.randn(Fo, C, 3, 3, generator=gen, device=device) / math.sqrt(
        9 * C)
    x2[(*NAN2D_AT, C // 2)] = nan
    g2[(*NAN2D_AT, Fo // 2)] = nan

    def around2d(t):
        """every channel of the 3x3 pixels around t's NaNs"""
        m = t.isnan().any(-1).float()[:, None]
        return F.max_pool2d(m, 3, stride=1, padding=1)[:, 0, ..., None] > 0

    keys2d = TF322D_KERNELS
    before = {k: conv2d.launches[k] for k in keys2d}
    outs2d = {
        "conv2d_same_fwd_tf32": (conv2d.conv2d_same(x2, w2),
                                 conv2d.conv2d_same_plain(x2, w2),
                                 around2d(x2)),
        "conv2d_dgrad_tf32": (conv2d.conv2d_dgrad(g2, w2),
                              conv2d.conv2d_same_plain(
                                  g2, conv2d.flip_swap(w2)), around2d(g2)),
        "conv2d_wgrad_tf32": (
            conv2d.conv2d_wgrad(x2, g2), conv2d.conv2d_wgrad_plain(x2, g2),
            conv2d.conv2d_wgrad_plain(x2.isnan().float(), torch.ones_like(g2))
            + conv2d.conv2d_wgrad_plain(torch.ones_like(x2),
                                        g2.isnan().float()) > 0.5),
    }
    torch.cuda.synchronize()
    assert all(conv2d.launches[k] == before[k] + 1 for k in keys2d), \
        f"NaN check: not every 3x3 kernel launched once: {before}"
    outs.update(outs2d)
    at.update({k: (NAN2D_CASE, NAN2D_AT) for k in outs2d})
    for k, (out, plain, want) in outs.items():
        want = want.expand_as(out)
        got = out.isnan()
        assert int(want.sum()) > 0 and torch.equal(got, want) \
            and bool(out[~got].isfinite().all()), \
            f"{k}: {int(got.sum())} NaNs where {int(want.sum())} belong"
        say(f"  {k:24s} NaN in {at[k][0]} at {at[k][1]}: "
            f"{int(got.sum())} NaNs, as the indicator's {int(want.sum())} "
            f"(plain version: {int(plain.isnan().sum())})")
    del x, g, w, x2, g2, w2, outs


def phase_conv2d_kernels(device, cases, record: dict) -> None:
    """Phase 3, the 3x3 family: each case asserts the route
    ``conv2d_route`` gives it (the launch counters that moved) and holds
    its forward, dgrad and wgrad kernels against their plain versions on
    ``device``, with the cuDNN call beside each (``F.conv2d``,
    ``torch.nn.grad.conv2d_weight``, in the inputs' dtype); where a case
    takes the tensor-core (bf16) or TF32 (fp32) route the CUDA-core
    kernels it replaces are held and timed too, and the TF32 kernels'
    errors against an fp64 conv or weight gradient are held against cuDNN
    fp32's (TF32 off)."""
    import torch
    import torch.nn.functional as F
    from cbim_tpu_torch.ops.kernels import conv2d
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(2)
    errs = record["errors"]
    errs.update({k: 0.0 for k in ("conv2d_same_fwd", "conv2d_wgrad",
                                  "conv2d_same_fwd_tc", "conv2d_wgrad_tc",
                                  "conv2d_same_fwd_tf32",
                                  "conv2d_wgrad_tf32")})
    route_keys = {conv2d.TENSOR_CORE: TC2D_KERNELS,
                  conv2d.TF32X3: TF322D_KERNELS,
                  conv2d.CUDA_CORE: CORE2D_KERNELS}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for case in cases:
            B, H, W, C, Fo = case
            x = torch.randn(B, H, W, C, generator=gen, device=device)
            g = torch.randn(B, H, W, Fo, generator=gen, device=device)
            w = torch.randn(Fo, C, 3, 3, generator=gen, device=device)
            x, g, w = x.to(dtype), g.to(dtype), (w / math.sqrt(9 * C)).to(dtype)
            ws = conv2d.flip_swap(w)
            route = conv2d.conv2d_route(dtype, C, Fo)
            replaces = route != conv2d.CUDA_CORE
            keys = route_keys[route]
            before = [conv2d.launches[k] for k in keys]
            y, ref_y = conv2d.conv2d_same(x, w), conv2d.conv2d_same_plain(x, w)
            dx = conv2d.conv2d_dgrad(g, w)
            ref_dx = conv2d.conv2d_same_plain(g, ws)
            dw, ref_dw = conv2d.conv2d_wgrad(x, g), conv2d.conv2d_wgrad_plain(x, g)
            torch.cuda.synchronize()
            assert [conv2d.launches[k] for k in keys] == \
                [n + 1 for n in before], f"{dt} {case} did not take {keys}"
            # the weight gradient sums over every pixel (0.5-2.1 M here):
            # cuDNN's fp32 sums err by up to 1e-4 of max|dW| at some of
            # these shapes on an H100 (PERF.md), so both are held against
            # the plain formula evaluated in fp64
            dw64 = torch.nn.grad.conv2d_weight(
                x.double().permute(0, 3, 1, 2), w.shape,
                g.double().permute(0, 3, 1, 2), padding=1)
            outs = {"fwd": y, "dgrad": dx, "wgrad": dw}
            if replaces:
                # the CUDA-core kernels the tensor-core or TF32 ones replace
                core = {"fwd": conv2d._launch_fwd(x, w, "conv2d_same_fwd"),
                        "dgrad": conv2d._launch_fwd(g, ws, "conv2d_dgrad"),
                        "wgrad": conv2d._launch_wgrad(x, g)}
                torch.cuda.synchronize()
            refs = {"fwd": ref_y, "dgrad": ref_dx, "wgrad": dw64}
            errors, core_err = {}, {}
            for key, ref in refs.items():
                scale = float(ref.float().abs().max())
                errors[key] = (float((outs[key].double() - ref.double())
                                     .abs().max()), scale)
                if replaces:
                    core_err[key] = float((core[key].double() - ref.double())
                                          .abs().max())
            f64, f64_rec = {}, {}
            if route == conv2d.TF32X3:
                f64 = {"fwd": f64_errors(f"{keys[0]} {case}", y, ref_y,
                                         conv64(x, w)),
                       "dgrad": f64_errors(f"{keys[1]} {case}", dx, ref_dx,
                                           conv64(g, ws)),
                       "wgrad": f64_errors(f"{keys[2]} {case}", dw, ref_dw,
                                           dw64, f64_rec)}
            plain_w_err = float((ref_dw.double() - dw64).abs().max())
            flops = 2 * 9 * C * Fo * B * H * W
            n = iters_for(flops, 1e10)
            xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # NCHW views
            t = {
                "fwd": (cuda_ms(lambda: conv2d.conv2d_same(x, w), n),
                        cuda_ms(lambda: conv2d.conv2d_same_plain(x, w), n),
                        cuda_ms(lambda: F.conv2d(xc, w, padding=1), n)),
                "dgrad": (cuda_ms(lambda: conv2d.conv2d_dgrad(g, w), n),
                          cuda_ms(lambda: conv2d.conv2d_same_plain(g, ws), n),
                          cuda_ms(lambda: F.conv2d(gc, ws, padding=1), n)),
                "wgrad": (cuda_ms(lambda: conv2d.conv2d_wgrad(x, g), n),
                          cuda_ms(lambda: conv2d.conv2d_wgrad_plain(x, g), n),
                          cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                              xc, w.shape, gc, padding=1), n))}
            core_ms = {}
            if replaces:
                core_ms = {
                    "fwd": cuda_ms(lambda: conv2d._launch_fwd(
                        x, w, "conv2d_same_fwd"), n),
                    "dgrad": cuda_ms(lambda: conv2d._launch_fwd(
                        g, ws, "conv2d_dgrad"), n),
                    "wgrad": cuda_ms(lambda: conv2d._launch_wgrad(x, g), n)}
            for (key, (ms, plain_ms, lib_ms)), name in zip(t.items(), keys):
                err, scale = errors[key]
                tol = WGRAD_TOL if key == "wgrad" else CONV_TOL[dt]
                vs = (f"vs fp64 (the fp32 plain version's: "
                      f"{plain_w_err / scale:.3e})" if key == "wgrad"
                      else "vs plain")
                line = (f"  {name:20s} {dt:8s} {case}: max_abs_err {err:.3e} "
                        f"max_rel_err {err / scale:.3e} of max|ref| "
                        f"{scale:.3f} {vs} (tol {tol:.1e}){f64.get(key, '')} "
                        f"kernel {ms:.3f} ms "
                        f"({flops / ms / 1e9:.1f} TFLOP/s) plain "
                        f"{plain_ms:.3f} ms cuDNN {lib_ms:.3f} ms "
                        f"({ms / lib_ms:.2f}x)")
                if replaces:
                    line += (f" CUDA-core {core_ms[key]:.3f} ms "
                             f"({core_ms[key] / ms:.2f}x) err "
                             f"{core_err[key] / scale:.3e}")
                say(line)
                assert err <= tol * scale, f"{name} {dt} {case}: {err:.3e}"
                if replaces:
                    assert core_err[key] <= tol * scale, \
                        f"CUDA-core {key} {dt} {case}: {core_err[key]:.3e}"
            kf, kw = keys[0], keys[2]
            errs[kf] = max(errs[kf], errors["fwd"][0], errors["dgrad"][0])
            errs[kw] = max(errs[kw], errors["wgrad"][0])
            if replaces:
                errs["conv2d_same_fwd"] = max(errs["conv2d_same_fwd"],
                                              core_err["fwd"],
                                              core_err["dgrad"])
                errs["conv2d_wgrad"] = max(errs["conv2d_wgrad"],
                                           core_err["wgrad"])
            if case == CONV2D_RECORD:
                # both dtypes take a replacing route here: its kernels and
                # the CUDA-core ones, same inputs; the CUDA-core record is
                # fp32's, with bf16's inside it
                size = x.element_size()
                fwd_bytes = (x.numel() + w.numel() + y.numel()) * size
                wg_bytes = (x.numel() + g.numel()) * size + dw.numel() * 4
                tf32 = route == conv2d.TF32X3
                kern = {k: v[0] for k, v in t.items()}
                core_rec = (entry(core_ms["fwd"], *t["fwd"][1:], flops,
                                  fwd_bytes, dt, case),
                            entry(core_ms["wgrad"], *t["wgrad"][1:], flops,
                                  wg_bytes, dt, case))
                if dt == "float32":
                    record["conv2d_same_fwd"], record["conv2d_wgrad"] = \
                        core_rec
                    record["conv2d_dgrad"] = (core_ms["dgrad"],
                                              *t["dgrad"][1:])
                else:
                    record["conv2d_same_fwd"][dt], \
                        record["conv2d_wgrad"][dt] = core_rec
                    record["conv2d_dgrad_" + dt] = (core_ms["dgrad"],
                                                    *t["dgrad"][1:])
                sfx = "_tf32" if tf32 else "_tc"
                record["conv2d_same_fwd" + sfx] = entry(
                    kern["fwd"], *t["fwd"][1:], flops, fwd_bytes, dt, case,
                    tf32x3=tf32)
                record["conv2d_wgrad" + sfx] = dict(entry(
                    kern["wgrad"], *t["wgrad"][1:], flops, wg_bytes, dt,
                    case, tf32x3=tf32), **f64_rec)
                record["conv2d_dgrad" + sfx] = (kern["dgrad"],
                                                *t["dgrad"][1:])
            del x, g, w, ws, y, ref_y, dx, ref_dx, dw, ref_dw, dw64, outs
            if replaces:
                del core
    torch.cuda.synchronize()


def attention64(q, k, v, rel_bias, region):
    """The window attention in fp64 on q's device (the reference of the
    fp32 kernel's and SDPA fp32's errors)."""
    import torch
    from cbim_tpu_torch.ops.kernels import window_attention as wa
    B, H, N, D = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q.double() * D ** -0.5, k.double())
    s = s + rel_bias.double()
    if region is not None:
        nW = region.shape[0]
        s = (s.view(B // nW, nW, H, N, N)
             + wa.region_mask(region).double()[None, :, None]
             ).view(B, H, N, N)
    return torch.einsum("bhnm,bhmd->bhnd", torch.softmax(s, -1), v.double())


def phase_window_attention(device, cases, record: dict) -> None:
    """Phase 3, the window attention: the kernel against its plain version
    at each shape, fp32 and bf16, with no mask and with the shifted-window
    region mask; q, k, v are the views of one packed (B, N, 3, H, D)
    tensor, as SwinUNETR passes them.  Beside it
    ``F.scaled_dot_product_attention`` on the same additive bias (rel_bias
    plus the -100 mask, pre-broadcast to (B, H, N, N) in the inputs'
    dtype).  In fp32 the kernel's error against an fp64 evaluation is at
    most F64_ERR_RATIO times SDPA fp32's (TF32 off).  The WA_TIMED shapes
    are timed (kernel, SDPA, plain), with the bound of three TF32 passes
    in fp32; the exponentials at the SFU's rate and the bias's L2 bytes,
    worked out from the shape, are printed and left out of the record.
    Also: on the card the wrapper raises where autograd would need a
    gradient."""
    import torch
    import torch.nn.functional as F
    from cbim_tpu_torch.models.swin_layers import compute_region_ids
    from cbim_tpu_torch.ops.kernels import window_attention as wa
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(5)
    errs = record["errors"]
    errs["window_attention"] = 0.0
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for (B, H, N, D), spatial, window in cases:
            qkv = torch.randn(B, N, 3, H, D, generator=gen,
                              device=device).to(dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            rel_bias = torch.randn(H, N, N, generator=gen, device=device)
            ids = compute_region_ids(spatial, window,
                                     tuple(w // 2 for w in window))
            timed = (B, H, N, D) in WA_TIMED
            for region in (None, torch.from_numpy(ids).to(device)):
                masked = region is not None
                ref = wa.window_attention_plain(q, k, v, rel_bias, region)
                out = wa.window_attention(q, k, v, rel_bias, region)
                bias = rel_bias.expand(B, H, N, N)
                if masked:
                    nW = region.shape[0]
                    bias = (bias.reshape(B // nW, nW, H, N, N)
                            + wa.region_mask(region)[None, :, None])
                bias = bias.reshape(B, H, N, N).to(dtype).contiguous()
                lib = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
                torch.cuda.synchronize()
                scale = float(ref.float().abs().max())
                err = float((out.float() - ref.float()).abs().max())
                line = (f"  window_attention {dt:8s} {(B, H, N, D)} "
                        f"mask={str(masked):5s}: max_abs_err {err:.3e} "
                        f"max_rel_err {err / scale:.3e} of max|o| "
                        f"{scale:.3f} (tol {WA_TOL[dt]:.1e})")
                f64 = {}
                if dt == "float32":
                    r64 = attention64(q, k, v, rel_bias, region)
                    s64 = float(r64.abs().max())
                    e_k = float((out.double() - r64).abs().max()) / s64
                    e_l = float((lib.double() - r64).abs().max()) / s64
                    line += (f" vs fp64: kernel {e_k:.3e} SDPA fp32 "
                             f"{e_l:.3e} of max|o|")
                    assert e_k <= F64_ERR_RATIO * e_l, \
                        f"window_attention {(B, H, N, D)} mask={masked}: " \
                        f"{e_k:.3e} from fp64, SDPA fp32 {e_l:.3e}"
                    f64 = dict(f64_err=e_k, sdpa_f64_err=e_l)
                    del r64
                assert err <= WA_TOL[dt] * scale, \
                    f"window_attention {dt} {(B, H, N, D)} mask={masked}"
                errs["window_attention"] = max(errs["window_attention"], err)
                if timed:
                    flops = 4 * B * H * N * N * D
                    n = iters_for(flops, 1e10)
                    ms = cuda_ms(lambda: wa.window_attention(
                        q, k, v, rel_bias, region), n)
                    plain_ms = cuda_ms(lambda: wa.window_attention_plain(
                        q, k, v, rel_bias, region), plain_iters(n))
                    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=bias), n)
                    nbytes = (4 * q.numel() * q.element_size()
                              + rel_bias.numel() * 4
                              + (region.numel() * 4 if masked else 0))
                    rec = dict(entry(ms, plain_ms, lib_ms, flops, nbytes,
                                     dt, (B, H, N, D),
                                     tf32x3=dt == "float32"), **f64)
                    # worked out from the shape, not measured: printed
                    # beside the bound, kept out of the record
                    Mp, Np = -(-N // 16) * 16, wa.padded_keys(N)
                    exp_ms = B * H * N * N / SFU_EXP_PER_S * 1e3
                    bias_bytes = B * H * Mp * Np * 4
                    line += (f" kernel {ms:.3f} ms "
                             f"({flops / ms / 1e9:.1f} TFLOP/s) bound "
                             f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}"
                             f"{', 3 TF32 passes' if f64 else ''}), exps "
                             f"{exp_ms:.3f} ms at the SFU's rate, "
                             f"bias {bias_bytes / 1e9:.2f} GB "
                             f"from L2; plain {plain_ms:.3f} ms SDPA "
                             f"{lib_ms:.3f} ms")
                    if ((B, H, N, D), masked, dt) == WA_RECORD:
                        record["window_attention"] = rec
                say(line)
                del ref, out, bias, lib
            del qkv, q, k, v, rel_bias
    qg = torch.randn(2, 3, 49, 16, device=device, requires_grad=True)
    try:
        wa.window_attention(qg, qg, qg, torch.zeros(3, 49, 49, device=device))
    except RuntimeError as e:
        assert "no backward" in str(e), e
    else:
        raise AssertionError("window_attention ran where autograd needs a "
                             "gradient")
    torch.cuda.synchronize()


def seeded_model(cfg, seed: int, train: bool = False):
    """A CPU model with seeded weights; BatchNorm running statistics drawn
    from the seed too (their initial 0 and 1 would leave eval-mode
    normalisation untested)."""
    import torch
    from cbim_tpu_torch.models import get_model
    gen = torch.Generator().manual_seed(seed)
    model = get_model(cfg, device="cpu", train=train, generator=gen)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)
    return model


def phase_depthwise_layouts(device, cases) -> None:
    """Phase 3, the choice of memory format for MedFormer-2D's grouped
    convs (``models/layers/convs.py``): cuDNN's depthwise 3x3 conv in bf16,
    forward and forward + backward, in contiguous NCHW and channels_last
    memory (input and weight alike).  Printed, not asserted."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(3)
    for B, H, W, C in cases:
        times = {}
        for fmt in ("contiguous_format", "channels_last"):
            mf = getattr(torch, fmt)
            x = torch.randn(B, C, H, W, generator=gen, device=device,
                            dtype=torch.bfloat16).contiguous(memory_format=mf)
            w = torch.randn(C, 1, 3, 3, generator=gen, device=device,
                            dtype=torch.bfloat16).contiguous(memory_format=mf)
            x.requires_grad_()
            w.requires_grad_()
            g = torch.randn_like(x)

            def fwd():
                return F.conv2d(x, w, padding=1, groups=C)

            n = iters_for(B * C * H * W * 2, 1e9)
            times[fmt] = (cuda_ms(fwd, n),
                          cuda_ms(lambda: fwd().backward(g), n))
            del x, w, g
        (c_f, c_fb), (l_f, l_fb) = times.values()
        say(f"  depthwise 3x3 bf16 (B, H, W, C) {(B, H, W, C)}: contiguous "
            f"fwd {c_f:.3f} ms fwd+bwd {c_fb:.3f} ms | channels_last fwd "
            f"{l_f:.3f} ms fwd+bwd {l_fb:.3f} ms")


def head0(out):
    """The logits of a model's output (head 0 of deep supervision)."""
    return out[0] if isinstance(out, (tuple, list)) else out


def phase_small_model(device, cfg_dict, shape) -> float:
    """Phases 4, 4c and 4d: the small model on ``device`` vs the CPU, same
    weights, on an input of ``shape`` (B, C, *spatial), eval mode."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    cfg = config_from_dict(cfg_dict)
    cpu_model = seeded_model(cfg, 1)
    dev_model = get_model(cfg, device=device)
    dev_model.load_state_dict(cpu_model.state_dict())
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        ref = torch.softmax(head0(cpu_model(x)), dim=1)
        out = torch.softmax(head0(dev_model(x.to(device))), dim=1).cpu()
    err = float((out - ref).abs().max())
    assert out.shape == (shape[0], cfg.classes, *shape[2:])
    assert torch.isfinite(out).all() and err <= MODEL_PROB_ATOL, err
    return err


#: phase_small_train_step's CPU results (loss, grads) by config and shape
CPU_STEPS: dict = {}


def phase_small_train_step(device, cfg_dict, shape, amp: bool = False
                           ) -> tuple[float, float, float]:
    """Phases 4b and 4c: one train-mode step of the small model on
    ``device`` and on the CPU, same weights and batch of ``shape`` (B, C,
    *spatial), fp32 on both or, with ``amp``, under bf16 autocast on the
    card.  Returns (loss relative error, the gradient's relative L2 error,
    the worst tensor's error against its tolerance scale, which only fp32
    asserts)."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.ops.losses import deep_supervision_loss
    cfg = config_from_dict(cfg_dict)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = seeded_model(cfg, 3, train=True)
    dev_model = get_model(cfg, device=device, train=True)
    dev_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(4)
    img = torch.randn(*shape, generator=gen)
    lab = torch.randint(0, cfg.classes, (shape[0], *shape[2:]), generator=gen)
    weight = [0.5] + [1.0] * (cfg.classes - 1)

    def step(model, dev):
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=amp and dev.type == "cuda"):
            loss = deep_supervision_loss(model(img.to(dev)), lab.to(dev),
                                         [0.5, 0.5], weight)
        loss.backward()
        # a parameter whose output the loss never reads (MedFormer-2D's
        # last semantic-map reductions) gets no grad: zeros, as in JAX
        return float(loss.detach()), {
            k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
            for k, p in model.named_parameters()}

    # the CPU's fp32 step runs the plain versions whatever the card's route
    # or autocast: one per config and shape serves every card step on it
    key = (json.dumps(cfg_dict, sort_keys=True, default=str), tuple(shape))
    if key not in CPU_STEPS:
        CPU_STEPS[key] = step(cpu_model, torch.device("cpu"))
    (ref_loss, ref_grads), (loss, grads) = CPU_STEPS[key], step(dev_model,
                                                                device)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    loss_tol = STEP_BF16_LOSS_RTOL if amp else STEP_LOSS_RTOL
    assert math.isfinite(loss) and loss_err <= loss_tol, loss_err
    l2_err = math.sqrt(sum(float((grads[k].float() - r).square().sum())
                           for k, r in ref_grads.items())
                       / sum(float(r.square().sum()) for r in ref_grads.values()))
    l2_tol = STEP_BF16_GRAD_L2 if amp else STEP_GRAD_L2
    assert l2_err <= l2_tol, f"gradient relative L2 error {l2_err:.3e}"
    top = max(float(r.abs().max()) for r in ref_grads.values())
    worst = 0.0
    for k, ref in ref_grads.items():
        # every parameter gets a finite gradient through the card's graph
        assert torch.isfinite(grads[k]).all(), k
        assert float(grads[k].abs().max()) > 0 or float(ref.abs().max()) == 0, k
        scale = float(ref.abs().max()) + STEP_GRAD_FLOOR * top
        err = float((grads[k].float() - ref).abs().max())
        assert amp or err <= STEP_GRAD_RTOL * scale, \
            f"{k}: {err:.3e} of {scale:.3e}"
        worst = max(worst, err / scale)
    return loss_err, l2_err, worst


def phase_small_validate(device, cfg_dict) -> dict:
    """Phase 4e: ``validate`` of the small model on a Synthetic3D test
    split, same seeded weights, on the CPU (plain versions) and then on
    the card (kernels, launch counters zeroed just before); returns the
    share of voxels both label maps agree on, the largest Dice difference,
    both results and the card's launch counts."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.data.datasets import Synthetic3D
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from cbim_tpu_torch.training import validation
    cfg = config_from_dict(cfg_dict)
    cpu_model = seeded_model(cfg, 5)
    dev_model = get_model(cfg, device=device)
    dev_model.load_state_dict(cpu_model.state_dict())
    testset = Synthetic3D(cfg, mode="test", k_fold=cfg.k_fold)
    maps = []
    calculate = validation.calculate_distance

    def recorded(pred, lab, spacing, num_classes):
        maps.append(pred)
        return calculate(pred, lab, spacing, num_classes)

    validation.calculate_distance = recorded
    try:
        ref = validation.validate(cpu_model, testset, cfg)
        reset_launch_counts()
        out = validation.validate(dev_model, testset, cfg)
        counts = launch_counts()
    finally:
        validation.calculate_distance = calculate
    n = len(testset)
    assert len(maps) == 2 * n, len(maps)
    same = sum(int((a == b).sum()) for a, b in zip(maps[:n], maps[n:]))
    dice_err = max(abs(a - b) for a, b in zip(out[0], ref[0]))
    return {"agreement": same / sum(m.size for m in maps[n:]),
            "dice_err": float(dice_err), "cpu": ref, "card": out,
            "launches": counts}


def phase_train_validate(device, cfg_dict, batch: int, name: str) -> dict:
    """Phases 6v and 8v: train a recipe with ``val_freq`` 1 through
    ``cbim_tpu_torch.train.main`` with bf16 autocast, so that its epoch
    ends in the EMA model's evaluation on the test split.  The launch
    counters are zeroed just before and read just after; the evaluation's
    model forwards are counted (the eval-mode calls of the model class),
    and per test volume its window sweep (to the label map on the host)
    and host distances are timed and the sweep's peak device memory read.
    """
    import torch
    from cbim_tpu_torch import train
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import medformer
    from cbim_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from cbim_tpu_torch.training import validation

    cfg = config_from_dict(cfg_dict)
    model_cls = (medformer.MedFormer2D if cfg.dimension == "2d"
                 else medformer.MedFormer3D)
    run = os.path.join(WORK, name)
    argv = ["--dataset", cfg.dataset, "--model", "medformer", "--dimension",
            cfg.dimension, "--batch_size", str(batch), "--amp",
            "--cp_path", os.path.join(run, "exp"),
            "--log_path", os.path.join(run, "log"), "--unique_name", name,
            "--folds", "1", "--device", str(device)]
    sweep, distances, peaks, forwards = [], [], [], []
    predict, calculate = validation.predict_labels, \
        validation.calculate_distance

    def timed_predict(engine, img, cfg, dev):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        labels = predict(engine, img, cfg, dev)       # ends on the host
        sweep.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(device))
        return labels

    def timed_calculate(*args):
        t0 = time.perf_counter()
        out = calculate(*args)
        distances.append(time.perf_counter() - t0)
        return out

    def count_forward(module, args, out):
        if isinstance(module, model_cls) and not module.training:
            forwards.append(1)

    validation.predict_labels = timed_predict
    validation.calculate_distance = timed_calculate
    hook = torch.nn.modules.module.register_module_forward_hook(
        count_forward)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with pipeline_recorder() as seen:
            (dice, hd, asd), = train.main(argv, cfg=cfg)
    finally:
        hook.remove()
        validation.predict_labels = predict
        validation.calculate_distance = calculate
    seconds = time.perf_counter() - t0
    counts = launch_counts()

    rows = [json.loads(ln) for ln in open(os.path.join(
        run, "log", cfg.dataset, name, "fold_0", "scalars.jsonl"))]
    step_loss = [r["value"] for r in rows if r["tag"] == "Train/StepLoss"]
    assert step_loss and all(math.isfinite(v) for v in step_loss), rows
    assert any(r["tag"] == "Dice/test_AVG" for r in rows), rows
    exp = os.path.join(run, "exp", cfg.dataset, name)
    assert os.path.exists(os.path.join(exp, "fold_0_best.ckpt"))
    for arr in (dice, hd, asd):
        assert arr.shape == (cfg.classes - 1,) and \
            all(math.isfinite(v) for v in arr), (dice, hd, asd)
    assert sweep and len(sweep) == len(distances), (sweep, distances)
    return {"dice": dice, "hd": hd, "asd": asd, "steps": len(step_loss),
            "eval_forwards": len(forwards), "sweep": sweep,
            "distances": distances, "peak_bytes": max(peaks),
            "seconds": seconds, "launches": counts,
            "path": pipeline_path(seen)}


def say_validation(res: dict) -> None:
    n = len(res["sweep"])
    sweep, dist = sum(res["sweep"]) / n, sum(res["distances"]) / n
    say(f"  {res['steps']} steps, then {n} test volume(s) in "
        f"{res['eval_forwards']} forwards: sec/volume {sweep + dist:.3f} "
        f"(window sweep {sweep:.3f}, host distances {dist:.3f}); sweep "
        f"peak device memory {res['peak_bytes'] / 2 ** 30:.2f} GiB; "
        f"train.main {res['seconds']:.1f} s; pipeline: {res['path']}")
    say(f"  mean Dice {res['dice'].mean():.4f}, HD95 {res['hd'].mean():.3f},"
        f" ASD {res['asd'].mean():.3f}; launches {res['launches']}")


def write_requests(in_dir: str, requests, seed: int = 0,
                   mr: bool = False) -> None:
    """Synthetic volumes from numpy, seeded: CT-like (HU, int16) or, with
    ``mr``, non-negative MR-like magnitudes."""
    import numpy as np
    from cbim_tpu_torch.data.nifti import write_nifti
    rng = np.random.default_rng(seed)
    os.makedirs(in_dir, exist_ok=True)
    for i, (shape, spacing) in enumerate(requests):
        vol = rng.normal(0.0, 400.0, size=shape).astype(np.float32)
        vol = np.abs(vol) if mr else np.clip(vol, -1024, 3000)
        write_nifti(os.path.join(in_dir, f"req{i}.nii.gz"),
                    vol.astype(np.int16), spacing=spacing)


def phase_slice(device, cfg_dict, requests, target_spacing, name: str,
                required, profile_dir: str | None = None) -> dict:
    """Phases 5, 7 and 9: serve ``requests`` with seeded weights through
    prediction; the launch counters and a count of the model's forwards are
    zeroed just before and read just after, and every kernel in
    ``required`` must have launched.  With ``profile_dir``, the requests
    are served once more under the profiler hook, a volume to a step."""
    import numpy as np
    import torch
    from cbim_tpu_torch import prediction
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.data.nifti import read_nifti
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    in_dir = os.path.join(WORK, name, "in")
    out_dir = os.path.join(WORK, name, "out")
    cfg = config_from_dict(cfg_dict)
    weights = os.path.join(WORK, name, f"{cfg.model}_seed0.pth")
    os.makedirs(os.path.dirname(weights), exist_ok=True)
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), weights)
    model_cls = type(model)
    del model
    write_requests(in_dir, requests, mr=cfg.dimension == "2d")
    argv = ["--dataset", cfg.dataset, "--model", cfg.model,
            "--dimension", cfg.dimension, "--load", weights, "--img_path",
            in_dir, "--save_path", out_dir, "--target_spacing",
            target_spacing, "--device", str(device)]

    forwards, shapes = [], collections.Counter()

    def count_forward(module, args, out):
        if isinstance(module, model_cls):
            forwards.append(1)

    hook = torch.nn.modules.module.register_module_forward_hook(
        count_forward)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    try:
        seconds = prediction.main(argv, cfg=cfg)
    finally:
        hook.remove()
    counts = launch_counts()

    assert len(seconds) == len(requests), seconds
    for req in sorted(seconds):
        src = read_nifti(os.path.join(in_dir, req))
        pred = read_nifti(os.path.join(out_dir, req)).data
        assert pred.shape == src.data.shape, (req, pred.shape)
        assert pred.dtype == np.uint8 and int(pred.max()) < cfg.classes
    missing = [k for k in required if counts[k] == 0]
    assert not missing, f"kernels never launched on the path: {missing}"
    peak = torch.cuda.max_memory_allocated(device)
    if profile_dir is not None:
        from cbim_tpu_torch.utils.profiling import StepProfiler
        prof = StepProfiler(profile_dir, device)
        with conv_shapes(shapes):
            prof.start()
            prediction.main(argv, cfg=cfg)
            prof.stop(len(requests))
    return {"seconds": seconds, "launches": counts, "forwards": len(forwards),
            "peak_bytes": peak, "conv_shapes": shapes}


@contextlib.contextmanager
def conv_shapes(counter: collections.Counter):
    """Count the 3^3 forwards by (function, x's shape [B, D, H, W, C], F)
    while inside (the profiled serving runs)."""
    from cbim_tpu_torch.ops.kernels import conv3d
    same, same_na = conv3d.conv3d_same, conv3d.conv3d_same_na

    def counted_same(x, w):
        counter["conv3d_same", tuple(x.shape), w.shape[0]] += 1
        return same(x, w)

    def counted_same_na(x, mean, rstd, w, act=None):
        counter["conv3d_same_na", tuple(x.shape), w.shape[0]] += 1
        return same_na(x, mean, rstd, w, act)

    conv3d.conv3d_same, conv3d.conv3d_same_na = counted_same, counted_same_na
    try:
        yield
    finally:
        conv3d.conv3d_same, conv3d.conv3d_same_na = same, same_na


def say_served_profile(profile: str | None, name: str, res: dict) -> None:
    """Under ``--profile``: a 3D serving phase's busy share and kernel time
    per volume, and its 3^3 forwards by shape in the profiled run."""
    if profile is None:
        return
    say_profile(os.path.join(profile, name), "volume")
    say("  3^3 forwards of the profiled run, by (B, D, H, W, C) -> F:")
    for (fn, shape, f), n in sorted(res["conv_shapes"].items()):
        say(f"    {n:5d} x {fn} {shape} -> {f}")


def phase_train(device, cfg_dict, batch: int, name: str, required,
                amp: bool = True, min_steps: int = WARMUP_STEPS + 3) -> dict:
    """Phases 6, 6k, 6a, 8 and 8f: train a recipe for one epoch through
    ``cbim_tpu_torch.train.main``, with bf16 autocast (``--amp``) or in
    fp32, the CLI's default; per-step losses and seconds come from the
    run's scalars.jsonl (one loss fetch per step).  ``cfg_dict``: a dict,
    or a config that ``load_config`` read from a shipped YAML.  The launch
    counters are zeroed just before and read just after, and every kernel
    in ``required`` must have launched."""
    import torch
    from cbim_tpu_torch import train
    from cbim_tpu_torch.config import Config, config_from_dict
    from cbim_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    cfg = cfg_dict if isinstance(cfg_dict, Config) else \
        config_from_dict(cfg_dict)
    run = os.path.join(WORK, name)
    argv = ["--dataset", cfg.dataset, "--model", "medformer", "--dimension",
            cfg.dimension, "--batch_size", str(batch),
            "--cp_path", os.path.join(run, "exp"),
            "--log_path", os.path.join(run, "log"), "--unique_name", name,
            "--folds", "1", "--device", str(device)] + \
        (["--amp"] if amp else [])

    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    with pipeline_recorder() as seen:
        train.main(argv, cfg=cfg)
    seconds = time.perf_counter() - t0
    counts = launch_counts()

    rows = [json.loads(ln) for ln in open(os.path.join(
        run, "log", cfg.dataset, name, "fold_0", "scalars.jsonl"))]
    step_loss = [r["value"] for r in rows if r["tag"] == "Train/StepLoss"]
    step_s = [r["value"] for r in rows if r["tag"] == "Perf/StepSeconds"]
    assert len(step_loss) >= min_steps, rows
    assert all(math.isfinite(v) for v in step_loss), step_loss
    assert os.path.exists(os.path.join(run, "exp", cfg.dataset, name,
                                       "fold_0_latest.ckpt"))
    missing = [k for k in required if counts[k] == 0]
    assert not missing, f"kernels never launched on the path: {missing}"
    warm = min(WARMUP_STEPS, len(step_s) - 1)
    median = statistics.median(step_s[warm:])
    return {"losses": step_loss, "step_seconds": step_s, "median": median,
            "warm": warm, "path": pipeline_path(seen), "seen": seen,
            "per_s": batch / median, "seconds": seconds,
            "peak_bytes": torch.cuda.max_memory_allocated(device),
            "launches": counts}


def say_profile(profile_dir: str, unit: str = "step") -> None:
    """The profiled window's busy share and its top kernels per step (or
    per ``unit``)."""
    with open(os.path.join(profile_dir, "summary.json")) as f:
        prof = json.load(f)
    n = prof["steps"]
    say(f"  profiled {n} {unit}s: {prof['wall_seconds'] / n * 1e3:.1f} "
        f"ms/{unit} wall, {prof['device_kernel_seconds'] / n * 1e3:.1f} "
        f"ms/{unit} of kernels, device busy "
        f"{100 * prof['device_busy_share']:.1f} %")
    total = prof["device_kernel_seconds"] / n * 1e3
    for fam, ms in prof["families_ms_per_step"].items():
        say(f"    {ms:8.3f} ms/{unit} {100 * ms / total:5.1f} %  {fam}")
    for name, ms, count in prof["kernels_ms"][:25]:
        say(f"    {ms / n:8.3f} ms/{unit} {count // n:5d}/{unit}  "
            f"{name[:110]}")


def say_train(tr: dict, unit: str) -> None:
    say(f"  losses {', '.join(f'{v:.4f}' for v in tr['losses'])}")
    say(f"  step seconds {', '.join(f'{v:.3f}' for v in tr['step_seconds'])}"
        f"; median after {tr['warm']} steps {tr['median']:.3f} s/step, "
        f"{tr['per_s']:.3f} {unit}/s; peak device memory "
        f"{tr['peak_bytes'] / 2 ** 30:.2f} GiB; train.main {tr['seconds']:.1f} s")
    say(f"  pipeline: {tr['path']}; launches {tr['launches']}")


def mean_seconds(res: dict) -> float:
    """A serving phase's mean seconds per volume."""
    return sum(res["seconds"].values()) / len(res["seconds"])


def label_agreement(dir_a: str, dir_b: str) -> float:
    """The share of voxels whose label is the same in the label maps of two
    serving runs (same request names)."""
    import numpy as np
    from cbim_tpu_torch.data.nifti import read_nifti
    same = total = 0
    for req in sorted(os.listdir(dir_a)):
        a = read_nifti(os.path.join(dir_a, req)).data
        b = read_nifti(os.path.join(dir_b, req)).data
        assert a.shape == b.shape, (req, a.shape, b.shape)
        same += int(np.count_nonzero(a == b))
        total += a.size
    return same / total


def say_serving(res: dict) -> None:
    secs = res["seconds"]
    say(f"  sec/volume {mean_seconds(res):.3f} "
        f"({', '.join(f'{k} {v:.3f}' for k, v in sorted(secs.items()))})"
        f"; peak device memory {res['peak_bytes'] / 2 ** 30:.2f} GiB; "
        f"{res['forwards']} forwards; launches {res['launches']}")


def phase_probes(device, record: dict) -> dict:
    """Phase 10: drive the three probe entry points at their full sizes
    with the launch counters zeroed just before and read just after; every
    probe kernel must have launched.  Then hold each probe kernel against
    its plain version (those launches are not counted) and time the plain
    version; the library time is the entry point's own case (``x * 2``,
    cuBLAS, cuDNN).  Returns the drive's launch counts."""
    import torch
    from cbim_tpu_torch.ops.kernels import (conv3d, launch_counts, probes,
                                            reset_launch_counts)
    from cbim_tpu_torch.tools import probe_bandwidth as pb
    from cbim_tpu_torch.tools import probe_conv_dissect as pc
    from cbim_tpu_torch.tools import probe_lhst_dot as pd

    reset_launch_counts()
    bw = pb.run(device)
    dots = pd.run(device)
    ladder = pc.run(device)
    counts = launch_counts()
    missing = [k for k in probes.launches if counts[k] == 0]
    assert not missing, f"probe kernels never launched: {missing}"
    errs = record["errors"]

    # copy-scale: exact (y = 2x is exact in bf16), every variant
    x = pb.make_input(device)
    ref = probes.copy_scale_plain(x)
    for name, (vec, block) in pb.KERNEL_CASES.items():
        assert torch.equal(probes.copy_scale(x, vec, block), ref), name
    flat = x.view(-1)
    for bad in (flat[1:], flat[:-1]):          # misaligned, or n % 8 != 0
        try:
            probes.copy_scale(bad, vec=True)
        except ValueError:
            pass
        else:
            raise AssertionError("the 16-byte copy-scale took a bad buffer")
    plain_ms = cuda_ms(lambda: probes.copy_scale_plain(x), 20)
    for name, r in bw.items():
        say(f"  probe_bandwidth {name:9s} {r['ms']:8.3f} ms "
            f"{r['gb_s']:6.0f} GB/s")
    b_ms, b_by = bound_ms(x.numel(), pb.nbytes(), "bfloat16")
    say(f"  probe_copy_scale: max_abs_err 0 (exact) in all "
        f"{len(pb.KERNEL_CASES)} variants; bound {b_ms:.3f} ms ({b_by}); "
        f"plain {plain_ms:.3f} ms; library (x * 2) "
        f"{bw['torch128']['ms']:.3f} ms")
    errs["probe_copy_scale"] = 0.0
    record["probe_copy_scale"] = entry(
        bw[COPY_RECORD]["ms"], plain_ms, bw["torch128"]["ms"], x.numel(),
        pb.nbytes(), "bfloat16", (pb.B, pb.S, pb.C))
    del x, ref, flat

    # the conv-shaped dot: a slice of tiles against the fp32 plain version
    a, w = pd.dot_inputs(device)
    half = DOT_CHECK_TILES // 2
    idx = torch.cat([torch.arange(half), torch.arange(pd.TILES - half,
                                                      pd.TILES)]).to(device)
    ref = probes.dot_t_plain(a[idx], w).float()
    scale = float(ref.abs().max())
    err = 0.0
    for stationary in (True, False):
        out = probes.dot_t(a, w, stationary)[idx].float()
        err = max(err, float((out - ref).abs().max()))
        del out
    assert err <= PROBE_TOL * scale, f"probe_dot_t: {err:.3e} of {scale:.3f}"
    plain_ms = cuda_ms(lambda: probes.dot_t_plain(a, w), 2)
    errs["probe_dot_t"] = err
    record["probe_dot_t"] = entry(
        dots[DOT_RECORD]["ms"], plain_ms, dots["cublas"]["ms"],
        *pd.dot_work(), "bfloat16", (pd.TILES, pd.K, pd.N, pd.L))
    for name in pd.DOT_CASES:
        r = dots[name]
        say(f"  probe_lhst_dot {name:10s} {r['ms']:8.3f} ms "
            f"{r['tflops']:6.1f} TFLOP/s {r['gb_s']:6.0f} GB/s")
    b_ms, b_by = bound_ms(*pd.dot_work(), "bfloat16")
    say(f"  probe_dot_t: max_abs_err {err:.3e} max_rel_err {err / scale:.3e} "
        f"of max|ref| {scale:.3f} on {DOT_CHECK_TILES} tiles (tol "
        f"{PROBE_TOL:.1e}); bound {b_ms:.3f} ms ({b_by}); plain "
        f"{plain_ms:.3f} ms; stationary/cuBLAS "
        f"{dots['stationary']['ms'] / dots['cublas']['ms']:.2f}x, "
        f"slab/cuBLAS {dots['slab']['ms'] / dots['cublas']['ms']:.2f}x")
    del a, w, idx, ref

    # the square calibration, whole
    a, b = pd.square_inputs(device)
    out, ref = probes.gemm(a, b).float(), probes.gemm_plain(a, b).float()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    assert err <= PROBE_TOL * scale, f"probe_gemm: {err:.3e} of {scale:.3f}"
    plain_ms = cuda_ms(lambda: probes.gemm_plain(a, b), 5)
    errs["probe_gemm"] = err
    record["probe_gemm"] = entry(
        dots["square1k"]["ms"], plain_ms, dots["cublas1k"]["ms"],
        *pd.square_work(), "bfloat16", (pd.SQ_TILES, pd.SQ, pd.SQ, pd.SQ))
    for name in pd.SQUARE_CASES:
        r = dots[name]
        say(f"  probe_lhst_dot {name:10s} {r['ms']:8.3f} ms "
            f"{r['tflops']:6.1f} TFLOP/s")
    b_ms, b_by = bound_ms(*pd.square_work(), "bfloat16")
    say(f"  probe_gemm: max_abs_err {err:.3e} max_rel_err {err / scale:.3e} "
        f"(tol {PROBE_TOL:.1e}); bound {b_ms:.3f} ms ({b_by}); plain "
        f"{plain_ms:.3f} ms; kernel/cuBLAS "
        f"{dots['square1k']['ms'] / dots['cublas1k']['ms']:.2f}x")
    del a, b, out, ref

    # the ladder: the full rung is the CUDA-core forward, equal to it in
    # fp32 (``conv3d_same`` at these widths takes the tensor-core route in
    # bf16 and the TF32 one in fp32: held to the conv's tolerance), and
    # within the conv's tolerance of F.conv3d in fp32 at both tile widths
    errs["conv3d_same_fwd_ladder"] = 0.0
    for name, (case, dt) in pc.SHAPES.items():
        x, w = pc.conv_inputs(case, dt, device)
        r = ladder[name]
        ref = probes.conv3d_same_fwd_ladder_plain(x, w).float()
        scale = float(ref.abs().max())
        full = probes.conv3d_same_fwd_ladder(x, w, "full")
        prod = conv3d.conv3d_same(x, w)
        if dt == "float32":
            core = conv3d._launch_fwd(x, w, "conv3d_same_fwd")
            assert torch.equal(full, core), \
                f"ladder full rung != the CUDA-core forward at {case} {dt}"
            del core
        prod_err = float((prod.float() - ref).abs().max())
        assert prod_err <= CONV_TOL[dt] * scale, \
            f"conv3d_same ({r['route']}) at {case} {dt}: {prod_err:.3e}"
        err = float((full.float() - ref).abs().max())
        for bn in probes.LADDER_BN:
            out = probes.conv3d_same_fwd_ladder(x, w, "full", bn).float()
            err = max(err, float((out - ref).abs().max()))
            del out
        assert err <= CONV_TOL[dt] * scale, f"ladder {case} {dt}: {err:.3e}"
        errs["conv3d_same_fwd_ladder"] = max(errs["conv3d_same_fwd_ladder"],
                                             err)
        plain_ms = cuda_ms(lambda: probes.conv3d_same_fwd_ladder_plain(x, w),
                           3)
        B, D, H, W, C, Fo = case
        flops = 2 * 27 * C * Fo * B * D * H * W
        nbytes = (x.numel() + w.numel() + full.numel()) * x.element_size()
        b_ms, b_by = bound_ms(flops, nbytes, dt)
        load_ms = x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        say(f"  ladder {dt} {case}: max_abs_err {err:.3e} max_rel_err "
            f"{err / scale:.3e} (tol {CONV_TOL[dt]:.1e}); bound {b_ms:.3f} "
            f"ms ({b_by}); x's bytes once {load_ms:.3f} ms; plain (F.conv3d "
            f"fp32) {plain_ms:.3f} ms; cuDNN {r['cudnn_ms']:.3f} ms; "
            f"conv3d_same ({r['route']}) {r['production_ms']:.3f} ms")
        for bn, rungs in r["rungs"].items():
            prev, steps = 0.0, []
            for phase, ms in rungs.items():
                steps.append(f"{phase} {ms:.3f} (+{ms - prev:.3f})")
                prev = ms
            say(f"    BN={bn}: " + ", ".join(steps) + " ms")
        if name == LADDER_RECORD:
            record["conv3d_same_fwd_ladder"] = dict(entry(
                r["rungs"][r["production_bn"]]["full"], plain_ms,
                r["cudnn_ms"], flops, nbytes, dt, case),
                rungs_ms=r["rungs"])
        del x, w, ref, full, prod
    torch.cuda.synchronize()
    return counts


def write_corpus(root: str, cases, names, seed: int, mr: bool = False,
                 classes: int = 3, frames: int = 0) -> None:
    """A converted-layout corpus (``{name}.nii.gz``, ``{name}_gt.nii.gz``
    and ``list/dataset.yaml``, gzip level 1): CT-like HU in int16 or, with
    ``mr``, non-negative MR-like magnitudes, random labels; ``frames`` > 0
    writes ACDC's ``{name}_{frame}`` pairs."""
    import numpy as np
    from cbim_tpu_torch.data.conversion.convert import write_name_list
    from cbim_tpu_torch.data.nifti import write_nifti
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for name, (shape, spacing) in zip(names, cases):
        for stem in ([f"{name}_{f}" for f in range(frames)] if frames
                     else [str(name)]):
            vol = rng.normal(40.0, 300.0, size=shape).astype(np.float32)
            vol = np.abs(vol) if mr else np.clip(vol, -1024, 3000).astype(
                np.int16)
            write_nifti(os.path.join(root, f"{stem}.nii.gz"), vol, spacing)
            write_nifti(os.path.join(root, f"{stem}_gt.nii.gz"),
                        rng.integers(0, classes, size=shape).astype(np.uint8),
                        spacing)
    write_name_list(root, list(names))


def kits_config(data_root: str, write: bool = True, **overrides):
    """Phase 6k's config: ``configs/kits/medformer_3d.yaml`` as shipped,
    read by the port's ``load_config`` with ``overrides``, for one epoch of
    KITS_STEPS steps on host windows over KITS_CASES, which it writes into
    ``data_root`` (seed 1) unless ``write`` is false (phase 6kn reads phase
    6k's)."""
    from cbim_tpu_torch.config import load_config
    if write:
        write_corpus(data_root, KITS_CASES, range(len(KITS_CASES)), seed=1)
    kw = dict(epochs=1, iter_per_epoch=KITS_STEPS, print_freq=1,
              device_cache=False)
    kw.update(overrides)
    return load_config("kits", "medformer", "3d", data_root=data_root, **kw)


def phase_aug_ops(device) -> dict:
    """Phase 3a: every augmentation op on the card against the same op on
    the CPU, with the same drawn scalars (and the noise tensor and the
    elastic control points given), at KiTS's post-crop batch (2 x 128^3)
    and ACDC-3D's full-volume cache rows (2 x 20 x 256 x 272, crops 16 x
    192 x 192).  Returns {op: (image error of max|ref|, labels equal)}."""
    import torch
    from cbim_tpu_torch.ops import augment as A
    from cbim_tpu_torch.ops.resample import affine_sample_3d_fullvol_batch

    gen = torch.Generator().manual_seed(0)
    kits_img = torch.randn(2, 128, 128, 128, 1, generator=gen)
    kits_lab = torch.randint(0, 3, (2, 128, 128, 128), generator=gen)
    # ACDC rows: volumes at the cache margin, zeros around them
    margin, cache = (1, 8, 8), (20, 256, 272)
    exts = torch.tensor([[18, 232, 216], [18, 240, 256]])
    rows = torch.zeros(2, *cache, 1)
    rows_lab = torch.zeros(2, *cache, dtype=torch.int8)
    mask = torch.zeros(2, *cache, 1, dtype=torch.bool)
    for b in range(2):
        box = tuple(slice(m, m + int(e)) for m, e in zip(margin, exts[b]))
        rows[(b, *box)] = torch.rand(*exts[b].tolist(), 1, generator=gen)
        rows_lab[(b, *box)] = torch.randint(0, 4, exts[b].tolist(),
                                            generator=gen, dtype=torch.int8)
        mask[(b, *box)] = True
    count = exts.float().prod(1)
    thetas = A.random_theta_3d(gen, 2, (0.1, 0.3, 0.3), (30, 0, 0),
                               (0.0, 0.0, 0.0), (0.05, 0.05, 0.05))
    starts = torch.tensor([[0, 17, 3], [1, 40, 60]])

    def u(lo, hi):
        return A.draw_uniform(gen, 2, lo, hi)

    cases = {
        "gamma": (A.gamma, (kits_img, u(0.7, 1.5))),
        "gamma_masked": (lambda x, g, m, c: A.gamma(x, g, True, mask=m,
                                                    count=c),
                         (rows, u(0.5, 1.6), mask, count)),
        "contrast": (A.contrast, (kits_img, u(0.65, 1.5))),
        "blur_sigma_lo": (lambda x, s: A.gaussian_blur(x, s, 1.0),
                          (kits_img, torch.full((2,), 0.5))),
        "blur_sigma_hi": (lambda x, s: A.gaussian_blur(x, s, 1.0),
                          (kits_img, torch.full((2,), 1.0))),
        "brightness_additive": (A.brightness_additive,
                                (kits_img, torch.randn(2, generator=gen) * 0.1)),
        "std_range_noise": (A.add_noise,
                            (kits_img, torch.randn(kits_img.shape,
                                                   generator=gen),
                             u(0.0, 0.1))),
        "elastic": (lambda x, y, d: A.elastic_deform(x, y, d, (0.05,) * 3),
                    (kits_img, kits_lab,
                     torch.rand(2, 3, 4, 4, 4, generator=gen) * 2 - 1)),
        "fullvol_resample": (
            lambda x, y, t, e, s: affine_sample_3d_fullvol_batch(
                x, y, t, e, s, margin, (16, 192, 192)),
            (rows, rows_lab, thetas, exts, starts)),
    }
    for axis in range(3):
        cases[f"mirror_{axis}"] = (lambda x, y, a=axis: A.mirror(x, y, a),
                                   (kits_img, kits_lab))
    out = {}
    for name, (fn, args) in cases.items():
        ref = fn(*args)
        got = fn(*[a.to(device) for a in args])
        torch.cuda.synchronize(device)
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        r, g = ref[0].float(), got[0].float().cpu()
        err = float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
        labels = len(ref) == 1 or torch.equal(got[1].cpu(), ref[1])
        out[name] = (err, labels)
        assert bool(torch.isfinite(g).all()), name
    return out


@contextlib.contextmanager
def pipeline_recorder():
    """While inside: every ``TrainPipeline`` built (the trainer's) and the
    number of full-volume resamples it ran.  Yields a dict."""
    from cbim_tpu_torch.data import pipeline
    seen = {"resamples": 0, "pipelines": []}
    resample, init = pipeline.affine_sample_3d_fullvol_batch, \
        pipeline.TrainPipeline.__init__

    def counted(*args, **kw):
        seen["resamples"] += 1
        return resample(*args, **kw)

    def recorded(self, *args, **kw):
        init(self, *args, **kw)
        seen["pipelines"].append(self)

    pipeline.affine_sample_3d_fullvol_batch = counted
    pipeline.TrainPipeline.__init__ = recorded
    try:
        yield seen
    finally:
        pipeline.affine_sample_3d_fullvol_batch = resample
        pipeline.TrainPipeline.__init__ = init


def time_batches(pipe, batch: int) -> list[float]:
    """Seconds of DATA_BATCHES of the pipeline's batches on their own, each
    from the call to the batch on the card (synchronised): the window
    draws, the copy or the cache gather, and the recipe's ops.  In training
    the host part overlaps the queued step and the card's part queues
    behind it, so this bounds the data path's share of a step."""
    import torch
    out = []
    for _ in range(DATA_BATCHES):
        torch.cuda.synchronize(pipe.device)
        t0 = time.perf_counter()
        pipe.next_batch(batch)
        torch.cuda.synchronize(pipe.device)
        out.append(time.perf_counter() - t0)
    return out


def pipeline_path(seen: dict) -> str:
    """Which way the trainer's pipeline fed the device: the device cache
    (its shape, dtype, full-volume or windows) or host windows."""
    pipe, = seen["pipelines"]
    if pipe.cache_img is None:
        return "host windows"
    return (f"device cache {tuple(pipe.cache_img.shape)} "
            f"{str(pipe.cache_img.dtype).replace('torch.', '')}, "
            f"{'full volume' if pipe.fullvol else 'windows'}")


def main(argv=None) -> int:
    t_start = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="trace phases 6, 6b, 6k, 6kn, 6a, 8, 8b and 8f's "
                             "steady steps, and the requests of phases 5, 5b "
                             "and 9 served again, into DIR")
    args = parser.parse_args(argv)

    def profile_dir(name):
        if args.profile is None:
            return None
        return os.path.abspath(os.path.join(args.profile, name))

    def profiled(cfg_dict, name):
        if args.profile is None:
            return cfg_dict
        return dict(cfg_dict, profile_dir=profile_dir(name))

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
        f"{_build.build_seconds:.1f} s (nvcc by source, side by side: "
        f"{_build.build_seconds_by_source} s); ptxas per kernel: "
        f"{'; '.join(regs)}")
    say("  tensor-core kernels (registers, spill stores/loads bytes): "
        + "; ".join(f"{k} {v}" for key in ("_tc_", "_tf32_")
                    for k, v in ptxas_report(_build.build_log, key).items()))

    record: dict = {}
    say("[phase 3] kernels vs plain versions")
    took = {}
    for part, fn, fn_args in (
            ("forward", phase_kernels, (CONV_CASES, NORM_CASES, record)),
            ("backward", phase_backward_kernels,
             (CONV_CASES, NORM_CASES, record)),
            ("fused pair", phase_na_kernels, (CONV_CASES, record)),
            ("NaN", phase_nan, ()),
            ("conv2d", phase_conv2d_kernels, (CONV2D_CASES, record)),
            ("depthwise", phase_depthwise_layouts, (DEPTHWISE2D_CASES,)),
            ("window attention", phase_window_attention,
             (WA_CASES, record))):
        t_part = time.perf_counter()
        fn(device, *fn_args)
        took[part] = round(time.perf_counter() - t_part, 1)
    say(f"  phase 3 took, by part: {took} s")

    say("[phase 3a] augmentation ops on the card vs the CPU, same draws")
    t_aug = time.perf_counter()
    for name, (err, labels) in phase_aug_ops(device).items():
        say(f"  {name}: max abs err {err:.3e} of max|ref| (tol {AUG_TOL:.0e})"
            f"; labels {'equal' if labels else 'DIFFER'}")
        assert err <= AUG_TOL and labels, (name, err, labels)
    say(f"  phase 3a took {time.perf_counter() - t_aug:.1f} s")

    from cbim_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    launches = {}
    say("[phase 4] small MedFormer-3D, card vs CPU")
    for conv_na in (False, True):
        reset_launch_counts()
        err = phase_small_model(device, dict(SMALL, conv_na=conv_na),
                                (1, 1, 64, 64, 64))
        counts = launch_counts()
        n_na = counts["conv3d_same_na_fwd_tf32"]
        say(f"  conv_na={conv_na}: 64^3 softmax max abs err {err:.3e} "
            f"(tol {MODEL_PROB_ATOL}); {n_na} conv3d_same_na_fwd_tf32 "
            f"launches")
        # fp32 at widths of multiples of 8: the TF32 forwards only
        assert n_na == (NA_CONVS if conv_na else 0), n_na
        assert counts["conv3d_same_fwd_tf32"] == (0 if conv_na else
                                                  NA_CONVS), counts
        assert not any(counts[k] for k in CONV3D_KERNELS
                       if not k.endswith("_tf32")), counts

    say("[phase 4b] one train step of the small MedFormer-3D, card vs CPU")
    for conv_na in (False, True):
        reset_launch_counts()
        loss_err, l2_err, grad_err = phase_small_train_step(
            device, dict(SMALL, remat=True, conv_na=conv_na),
            (2, 1, 64, 64, 64))
        counts = launch_counts()
        # the fp32 step: forwards, dgrads and wgrads on the TF32 kernels,
        # with conv_na the fused pair's too
        used = (NA_TF32_KERNELS + ("conv3d_dgrad_tf32",) if conv_na
                else TF32_CONV_KERNELS)
        assert all(counts[k] > 0 for k in used) and \
            not any(counts[k] for k in CONV3D_KERNELS if k not in used), \
            counts
        n_na = counts["conv3d_wgrad_na_tf32"]
        say(f"  conv_na={conv_na}: 2 x 64^3 fp32: loss rel err "
            f"{loss_err:.3e} (tol {STEP_LOSS_RTOL:.0e}); gradient rel L2 err "
            f"{l2_err:.3e} (tol {STEP_GRAD_L2:.0e}); worst tensor err "
            f"{grad_err:.3e} of its scale (tol {STEP_GRAD_RTOL:.0e}); "
            f"{n_na} conv3d_wgrad_na_tf32 launches")
        assert n_na == (NA_CONVS if conv_na else 0), n_na
    for conv_na in (False, True):
        reset_launch_counts()
        loss_err, l2_err, grad_err = phase_small_train_step(
            device, dict(SMALL, remat=True, conv_na=conv_na),
            (2, 1, 64, 64, 64), amp=True)
        counts = launch_counts()
        keys = TC_CONV_KERNELS + CORE_CONV_KERNELS + NA_TC_KERNELS + \
            NA_CORE_KERNELS
        say(f"  bf16 autocast on the card vs fp32 on the CPU, conv_na="
            f"{conv_na}: loss rel err {loss_err:.3e} (tol "
            f"{STEP_BF16_LOSS_RTOL:.0e}); gradient rel L2 err {l2_err:.3e} "
            f"(tol {STEP_BF16_GRAD_L2:.0e}); worst tensor err "
            f"{grad_err:.3e} of its scale; 3^3 launches "
            f"{ {k: counts[k] for k in keys if counts[k]} }")
        # bf16 at these widths: the tensor-core kernels only, the fused
        # pair's too with conv_na (20 fused convs, remat: 40 forwards)
        used = ("conv3d_dgrad_tc",) if conv_na else TC_CONV_KERNELS
        assert all(counts[k] > 0 for k in used) and \
            not any(counts[k] for k in CORE_CONV_KERNELS + NA_CORE_KERNELS
                    + TF32_CONV_KERNELS + NA_TF32_KERNELS), counts
        assert (counts["conv3d_same_na_fwd_tc"],
                counts["conv3d_wgrad_na_tc"]) == \
            ((2 * NA_CONVS, NA_CONVS) if conv_na else (0, 0)), counts
    # the same bf16 step with every 3^3 conv on the CUDA-core kernels (the
    # route forced for this reference run only): bf16's own error here
    from cbim_tpu_torch.ops.kernels import conv3d
    route = conv3d.conv3d_route
    conv3d.conv3d_route = lambda *args: conv3d.CUDA_CORE
    try:
        core_loss, core_l2, _ = phase_small_train_step(
            device, dict(SMALL, remat=True), (2, 1, 64, 64, 64), amp=True)
    finally:
        conv3d.conv3d_route = route
    say(f"  the same with the CUDA-core 3^3 kernels: loss rel err "
        f"{core_loss:.3e}; gradient rel L2 err {core_l2:.3e}")

    say("[phase 4c] small MedFormer-2D (BatchNorm), card vs CPU")
    reset_launch_counts()
    err = phase_small_model(device, SMALL2D, (6, 1, 128, 128))
    say(f"  eval, 6 x 128^2 softmax max abs err {err:.3e} "
        f"(tol {MODEL_PROB_ATOL})")
    loss_err, l2_err, grad_err = phase_small_train_step(
        device, SMALL2D, (4, 1, 128, 128))
    say(f"  train step, 4 x 128^2 fp32: loss rel err {loss_err:.3e} "
        f"(tol {STEP_LOSS_RTOL:.0e}); gradient rel L2 err {l2_err:.3e} "
        f"(tol {STEP_GRAD_L2:.0e}); worst tensor err {grad_err:.3e} of its "
        f"scale (tol {STEP_GRAD_RTOL:.0e})")
    # fp32 at widths of multiples of 8: the TF32 3x3 kernels, backward
    # included, and no other 3x3 kernel
    counts = launch_counts()
    assert all(counts[k] > 0 for k in TF322D_KERNELS) and \
        not any(counts[k] for k in TC2D_KERNELS + CORE2D_KERNELS), counts

    say("[phase 4d] small SwinUNETR, card vs CPU")
    for shape in SMALL_SWIN_SHAPES:
        err = phase_small_model(device, SMALL_SWIN, shape)
        say(f"  {shape} softmax max abs err {err:.3e} "
            f"(tol {MODEL_PROB_ATOL})")

    say("[phase 4e] validate of the small MedFormer-3D on a Synthetic3D "
        "test volume, card vs CPU")
    val = phase_small_validate(device, SMALL_VAL)
    counts = val["launches"]
    say(f"  label maps agree on {100 * val['agreement']:.4f} % of voxels "
        f"(min {100 * VAL_LABEL_AGREEMENT} %); Dice card "
        f"{[round(float(v), 4) for v in val['card'][0]]} vs CPU "
        f"{[round(float(v), 4) for v in val['cpu'][0]]}, max diff "
        f"{val['dice_err']:.2e} (tol {VAL_DICE_ATOL}); HD95 card "
        f"{[round(float(v), 3) for v in val['card'][2]]} vs CPU "
        f"{[round(float(v), 3) for v in val['cpu'][2]]}")
    assert val["agreement"] >= VAL_LABEL_AGREEMENT, val["agreement"]
    assert val["dice_err"] <= VAL_DICE_ATOL, val["dice_err"]
    # fp32 at widths of multiples of 8: the TF32 forward only, 20 a forward
    assert counts["conv3d_same_fwd_tf32"] > 0 and \
        counts["conv3d_same_fwd_tf32"] % NA_CONVS == 0 and not any(
            counts[k] for k in CONV3D_KERNELS
            if k != "conv3d_same_fwd_tf32"), counts
    assert all(counts[k] > 0 for k in FORWARD_KERNELS), counts
    launches["4e"] = counts

    say("[phase 5] AMOS-CT MedFormer-3D serving 2 NIfTI requests")
    res = phase_slice(device, AMOS, REQUESTS, TARGET_SPACING, "serve3d",
                      FORWARD_KERNELS, profile_dir("serve3d"))
    say_serving(res)
    # fp32 serving: every 3^3 conv on the TF32 forward, 20 a forward
    counts = res["launches"]
    assert res["forwards"] > 0 and counts["conv3d_same_fwd_tf32"] == \
        NA_CONVS * res["forwards"] and not any(
            counts[k] for k in CONV3D_KERNELS
            if k != "conv3d_same_fwd_tf32"), \
        f"{counts} in {res['forwards']} forwards"
    say_served_profile(args.profile, "serve3d", res)
    launches["5"] = counts

    say("[phase 5b] the same requests with conv_na: the fused preact conv")
    res_na = phase_slice(device, dict(AMOS, conv_na=True), REQUESTS,
                         TARGET_SPACING, "serve3d_na", NA_FORWARD_KERNELS,
                         profile_dir("serve3d_na"))
    say_serving(res_na)
    counts = res_na["launches"]
    assert res_na["forwards"] > 0 and counts["conv3d_same_na_fwd_tf32"] == \
        NA_CONVS * res_na["forwards"] and not any(
            counts[k] for k in CONV3D_KERNELS
            if k != "conv3d_same_na_fwd_tf32"), \
        f"{counts} in {res_na['forwards']} forwards"
    say_served_profile(args.profile, "serve3d_na", res_na)
    agree = label_agreement(os.path.join(WORK, "serve3d", "out"),
                            os.path.join(WORK, "serve3d_na", "out"))
    say(f"  fused vs unfused (phase 5): {mean_seconds(res_na):.3f} vs "
        f"{mean_seconds(res):.3f} sec/volume, peak "
        f"{res_na['peak_bytes'] / 2 ** 30:.2f} vs "
        f"{res['peak_bytes'] / 2 ** 30:.2f} GiB; label maps agree on "
        f"{100 * agree:.4f} % of voxels (min {100 * LABEL_AGREEMENT} %)")
    assert agree >= LABEL_AGREEMENT, agree
    launches["5b"] = counts

    say("[phase 6] flagship MedFormer-3D training, bf16, remat all, "
        f"batch {TRAIN_BATCH}, {FLAGSHIP['iter_per_epoch']} steps")
    tr = phase_train(device, profiled(FLAGSHIP, "flagship"), TRAIN_BATCH,
                     "flagship",
                     ("inorm_stats", "inorm_apply", "inorm_bwd_stats",
                      "inorm_bwd_apply") + TC_CONV_KERNELS)
    say_train(tr, "volumes")
    say("  (the launches include the forward that remat recomputes)")
    # every 3^3 conv of the bf16 step on the tensor-core route: per step
    # 40 forwards (remat incl.), 20 dgrads, 20 wgrads, no CUDA-core launch
    steps = len(tr["step_seconds"])
    want = dict(conv3d_same_fwd_tc=2 * NA_CONVS * steps,
                conv3d_dgrad_tc=NA_CONVS * steps,
                conv3d_wgrad_tc=NA_CONVS * steps,
                **{k: 0 for k in CORE_CONV_KERNELS})
    assert all(tr["launches"][k] == v for k, v in want.items()), \
        (tr["launches"], want)
    if args.profile:
        say_profile(os.path.join(args.profile, "flagship"))
    launches["6"] = tr["launches"]

    say("[phase 6b] the flagship recipe with conv_na: the fused preact conv")
    tr_na = phase_train(device, profiled(dict(FLAGSHIP, conv_na=True),
                                         "flagship_na"), TRAIN_BATCH,
                        "flagship_na",
                        ("inorm_stats", "inorm_apply", "inorm_bwd_stats",
                         "inorm_bwd_apply", "conv3d_dgrad_tc")
                        + NA_TC_KERNELS)
    say_train(tr_na, "volumes")
    counts, steps = tr_na["launches"], len(tr_na["step_seconds"])
    # every fused conv on the tensor-core pair (40 forwards with remat, 20
    # wgrads), its dgrad the tensor-core one; no CUDA-core 3^3 launch
    want = dict(conv3d_same_na_fwd_tc=2 * NA_CONVS * steps,
                conv3d_wgrad_na_tc=NA_CONVS * steps,
                conv3d_dgrad_tc=NA_CONVS * steps, conv3d_same_fwd_tc=0,
                conv3d_wgrad_tc=0,
                **{k: 0 for k in CORE_CONV_KERNELS + NA_CORE_KERNELS})
    assert all(counts[k] == v for k, v in want.items()), (counts, want)
    say(f"  fused vs unfused (phase 6): {tr_na['median']:.3f} vs "
        f"{tr['median']:.3f} s/step, peak {tr_na['peak_bytes'] / 2 ** 30:.2f}"
        f" vs {tr['peak_bytes'] / 2 ** 30:.2f} GiB")
    if args.profile:
        say_profile(os.path.join(args.profile, "flagship_na"))
    launches["6b"] = counts
    for key in ("conv3d_dgrad", "conv3d_dgrad_tf32", "conv3d_dgrad_bfloat16",
                "conv3d_dgrad_tc"):
        ms, plain_ms, lib_ms = record[key]
        say(f"  {key} at {CONV_RECORD}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, cuDNN {lib_ms:.3f} ms")

    say("[phase 6v] the flagship recipe validating: 2 steps on five 130^3 "
        "volumes, then the EMA model's 128^3 sliding-window evaluation")
    tv = phase_train_validate(device, FLAGSHIP_VAL, TRAIN_BATCH,
                              "flagship_val")
    say_validation(tv)
    counts, steps = tv["launches"], tv["steps"]
    # bf16 evaluation on the tensor-core forward: 20 a forward (no remat
    # in eval), beside the steps' 40 forwards, 20 dgrads and 20 wgrads
    assert tv["eval_forwards"] == 2, tv["eval_forwards"]
    want = dict(conv3d_same_fwd_tc=NA_CONVS * (2 * steps
                                               + tv["eval_forwards"]),
                conv3d_dgrad_tc=NA_CONVS * steps,
                conv3d_wgrad_tc=NA_CONVS * steps,
                **{k: 0 for k in CORE_CONV_KERNELS + TF32_CONV_KERNELS})
    assert all(counts[k] == v for k, v in want.items()), (counts, want)
    launches["6v"] = counts

    say("[phase 6k] the KiTS recipe as shipped (configs/kits/"
        "medformer_3d.yaml), fp32, batch 2, on written NIfTI cases")
    t_corpus = time.perf_counter()
    kits = kits_config(os.path.join(WORK, "kits_data"),
                       profile_dir=profile_dir("kits"))
    say(f"  wrote {len(KITS_CASES)} cases in "
        f"{time.perf_counter() - t_corpus:.1f} s")
    tr = phase_train(device, kits, TRAIN_BATCH, "kits",
                     ("inorm_stats", "inorm_apply", "inorm_bwd_stats",
                      "inorm_bwd_apply") + TF32_CONV_KERNELS,
                     amp=False, min_steps=KITS_STEPS)
    say_train(tr, "volumes")
    counts, steps = tr["launches"], len(tr["step_seconds"])
    # fp32 at widths of multiples of 8: the 3xTF32 kernels, per conv and
    # step 2 forwards (remat), 1 dgrad, 1 wgrad; no tensor-core and no
    # CUDA-core 3^3 launch
    want = dict(conv3d_same_fwd_tf32=2 * KITS_CONVS * steps,
                conv3d_dgrad_tf32=KITS_CONVS * steps,
                conv3d_wgrad_tf32=KITS_CONVS * steps,
                **{k: 0 for k in CONV3D_KERNELS
                   if k not in TF32_CONV_KERNELS})
    assert steps == KITS_STEPS and all(counts[k] == v
                                       for k, v in want.items()), \
        (counts, want)
    assert tr["path"] == "host windows", tr["path"]
    pipe, = tr["seen"]["pipelines"]
    data_s = time_batches(pipe, TRAIN_BATCH)
    say(f"  conv3d_wgrad_tf32 launches {counts['conv3d_wgrad_tf32']}, "
        f"{KITS_CONVS} a step; host-window batches alone "
        f"{', '.join(f'{1e3 * v:.1f}' for v in data_s)} ms")
    if args.profile:
        say_profile(os.path.join(args.profile, "kits"))
    launches["6k"] = counts
    kits_median = tr["median"]

    say("[phase 6kn] the KiTS recipe as shipped with conv_na: true, fp32: "
        "the fused preact conv on the TF32 pair")
    kits_na = kits_config(os.path.join(WORK, "kits_data"), write=False,
                          conv_na=True, iter_per_epoch=KITS_NA_STEPS,
                          profile_dir=profile_dir("kits_na"))
    tr = phase_train(device, kits_na, TRAIN_BATCH, "kits_na",
                     ("inorm_stats", "inorm_bwd_stats", "inorm_bwd_apply",
                      "conv3d_dgrad_tf32") + NA_TF32_KERNELS,
                     amp=False, min_steps=KITS_NA_STEPS)
    say_train(tr, "volumes")
    counts, steps = tr["launches"], len(tr["step_seconds"])
    # every kernel conv fused (16, all preact InstanceNorm BasicBlock
    # convs): per step 32 fused forwards (remat), 16 dgrads and 16 fused
    # wgrads on the TF32 kernels; no other 3^3 launch, the CUDA-core fused
    # wgrad none
    want = dict(conv3d_same_na_fwd_tf32=2 * KITS_CONVS * steps,
                conv3d_dgrad_tf32=KITS_CONVS * steps,
                conv3d_wgrad_na_tf32=KITS_CONVS * steps,
                **{k: 0 for k in CONV3D_KERNELS
                   if k not in NA_TF32_KERNELS + ("conv3d_dgrad_tf32",)})
    assert steps == KITS_NA_STEPS and all(counts[k] == v
                                          for k, v in want.items()), \
        (counts, want)
    say(f"  fused vs unfused (phase 6k): {tr['median']:.3f} vs "
        f"{kits_median:.3f} s/step; conv3d_wgrad_na_tf32 launches "
        f"{counts['conv3d_wgrad_na_tf32']}, conv3d_wgrad_na "
        f"{counts['conv3d_wgrad_na']}")
    if args.profile:
        say_profile(os.path.join(args.profile, "kits_na"))
    launches["6kn"] = counts

    say("[phase 6a] the ACDC-3D recipe (configs/acdc/medformer_3d.yaml) on "
        "the device cache's full-volume path, fp32, batch 2")
    from cbim_tpu_torch.config import load_config
    acdc_root = os.path.join(WORK, "acdc3d_data")
    names = [f"patient{i:03d}" for i in range(1, len(ACDC3D_CASES) + 1)]
    write_corpus(acdc_root, ACDC3D_CASES, names, seed=2, mr=True, classes=4,
                 frames=2)
    acdc3d = load_config("acdc", "medformer", "3d", data_root=acdc_root,
                         epochs=1, iter_per_epoch=ACDC3D_STEPS, print_freq=1)
    if args.profile:
        acdc3d.profile_dir = profile_dir("acdc3d")
    tr = phase_train(device, acdc3d, TRAIN_BATCH, "acdc3d",
                     ("inorm_stats", "inorm_apply"), amp=False,
                     min_steps=ACDC3D_STEPS)
    say_train(tr, "volumes")
    seen = tr["seen"]
    pipe, = seen["pipelines"]
    say(f"  cache margins {pipe.cache_margin.tolist()}; {seen['resamples']} "
        f"full-volume resamples in {len(tr['step_seconds'])} steps")
    # one batch a step, and the one prepared after the last step's dispatch
    # is not drawn (the trainer prepares a batch only for a next step)
    assert pipe.cache_img is not None and pipe.fullvol and \
        seen["resamples"] == len(tr["step_seconds"]) == ACDC3D_STEPS, seen
    data_s = time_batches(pipe, TRAIN_BATCH)
    say("  full-volume batches alone "
        f"{', '.join(f'{1e3 * v:.1f}' for v in data_s)} ms")
    if args.profile:
        say_profile(os.path.join(args.profile, "acdc3d"))
    launches["6a"] = tr["launches"]

    say("[phase 7] ACDC MedFormer-2D serving 2 NIfTI requests (slice batch)")
    res = phase_slice(device, ACDC, REQUESTS_2D, TARGET_SPACING_2D, "serve2d",
                      ("conv2d_same_fwd_tf32",))
    say_serving(res)
    # fp32 serving: every 3x3 kernel conv on the TF32 forward, 14 a forward,
    # and no other 3x3 kernel
    counts = res["launches"]
    assert res["forwards"] > 0 and counts["conv2d_same_fwd_tf32"] == \
        ACDC_CONVS * res["forwards"] and not any(
            counts[k] for k in CONV2D_KERNELS
            if k != "conv2d_same_fwd_tf32"), \
        f"{counts} in {res['forwards']} forwards"
    launches["7"] = counts

    say("[phase 7b] the same requests with conv2d_kernel off (cuDNN fp32)")
    res_off = phase_slice(device, dict(ACDC, conv2d_kernel=False),
                          REQUESTS_2D, TARGET_SPACING_2D, "serve2d_cudnn", ())
    say_serving(res_off)
    counts = res_off["launches"]
    assert not any(counts[k] for k in CONV2D_KERNELS), counts
    agree = label_agreement(os.path.join(WORK, "serve2d", "out"),
                            os.path.join(WORK, "serve2d_cudnn", "out"))
    say(f"  kernel route (phase 7) vs cuDNN: {mean_seconds(res):.3f} vs "
        f"{mean_seconds(res_off):.3f} sec/volume, peak "
        f"{res['peak_bytes'] / 2 ** 30:.2f} vs "
        f"{res_off['peak_bytes'] / 2 ** 30:.2f} GiB; label maps agree on "
        f"{100 * agree:.4f} % of pixels (min {100 * LABEL_AGREEMENT} %)")
    assert agree >= LABEL_AGREEMENT, agree
    launches["7b"] = counts

    say(f"[phase 8] ACDC MedFormer-2D training, bf16, batch {TRAIN2D_BATCH}, "
        "one epoch of Synthetic2D")
    tr = phase_train(device, profiled(ACDC_TRAIN, "acdc2d"), TRAIN2D_BATCH,
                     "acdc2d", TC2D_KERNELS)
    say_train(tr, "slices")
    # every 3x3 conv of the bf16 step on the tensor-core route: per step 14
    # forwards, 14 dgrads, 14 wgrads, and no CUDA-core 3x3 launch
    steps = len(tr["step_seconds"])
    want = dict({k: ACDC_CONVS * steps for k in TC2D_KERNELS},
                **{k: 0 for k in CORE2D_KERNELS})
    assert all(tr["launches"][k] == v for k, v in want.items()), \
        (tr["launches"], want)
    if args.profile:
        say_profile(os.path.join(args.profile, "acdc2d"))
    launches["8"] = tr["launches"]
    for key in ("conv2d_dgrad", "conv2d_dgrad_tf32", "conv2d_dgrad_bfloat16",
                "conv2d_dgrad_tc"):
        ms, plain_ms, lib_ms = record[key]
        say(f"  {key} at {CONV2D_RECORD}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, cuDNN {lib_ms:.3f} ms")

    say("[phase 8b] the ACDC recipe with conv2d_kernel off (the default: "
        "cuDNN's 3x3 convs)")
    tr_off = phase_train(device, profiled(dict(ACDC_TRAIN,
                                               conv2d_kernel=False),
                                          "acdc2d_cudnn"),
                         TRAIN2D_BATCH, "acdc2d_cudnn", ())
    say_train(tr_off, "slices")
    if args.profile:
        say_profile(os.path.join(args.profile, "acdc2d_cudnn"))
    counts = tr_off["launches"]
    assert not any(counts[k] for k in CONV2D_KERNELS), counts
    say(f"  cuDNN (default) vs kernel route (phase 8): "
        f"{tr_off['median']:.3f} vs {tr['median']:.3f} s/step, "
        f"{tr_off['per_s']:.1f} vs {tr['per_s']:.1f} slices/s, peak "
        f"{tr_off['peak_bytes'] / 2 ** 30:.2f} vs "
        f"{tr['peak_bytes'] / 2 ** 30:.2f} GiB")
    launches["8b"] = counts

    say(f"[phase 8f] the ACDC recipe in fp32 (the CLI's default), batch "
        f"{TRAIN2D_BATCH}, on the TF32 3x3 kernels")
    tr32 = phase_train(device, profiled(ACDC_TRAIN, "acdc2d_fp32"),
                       TRAIN2D_BATCH, "acdc2d_fp32", TF322D_KERNELS,
                       amp=False)
    say_train(tr32, "slices")
    if args.profile:
        say_profile(os.path.join(args.profile, "acdc2d_fp32"))
    # every 3x3 conv of the fp32 step on the TF32 route: per step 14
    # forwards, 14 dgrads, 14 wgrads, and no other 3x3 kernel
    counts, steps = tr32["launches"], len(tr32["step_seconds"])
    want = dict({k: ACDC_CONVS * steps for k in TF322D_KERNELS},
                **{k: 0 for k in TC2D_KERNELS + CORE2D_KERNELS})
    assert all(counts[k] == v for k, v in want.items()), (counts, want)
    say(f"  fp32 vs bf16 (phase 8): {tr32['median']:.3f} vs "
        f"{tr['median']:.3f} s/step, {tr32['per_s']:.1f} vs "
        f"{tr['per_s']:.1f} slices/s, peak "
        f"{tr32['peak_bytes'] / 2 ** 30:.2f} vs "
        f"{tr['peak_bytes'] / 2 ** 30:.2f} GiB")
    launches["8f"] = counts

    say("[phase 8v] the ACDC recipe validating: one step, then the EMA "
        "model's evaluation of 2 test volumes (slice batch, whole image)")
    tv = phase_train_validate(device, ACDC_VAL, TRAIN2D_BATCH, "acdc2d_val")
    say_validation(tv)
    counts, steps = tv["launches"], tv["steps"]
    # bf16 evaluation on the tensor-core 3x3 forward: 14 a forward
    assert tv["eval_forwards"] == 2, tv["eval_forwards"]
    want = dict(conv2d_same_fwd_tc=ACDC_CONVS * (steps + tv["eval_forwards"]),
                conv2d_dgrad_tc=ACDC_CONVS * steps,
                conv2d_wgrad_tc=ACDC_CONVS * steps,
                **{k: 0 for k in CORE2D_KERNELS})
    assert all(counts[k] == v for k, v in want.items()), (counts, want)
    launches["8v"] = counts

    say("[phase 9] BCV SwinUNETR serving 2 NIfTI requests")
    res = phase_slice(device, BCV, REQUESTS, TARGET_SPACING, "serve_swin",
                      ("window_attention",), profile_dir("swin"))
    say_serving(res)
    if args.profile is not None:
        say_profile(profile_dir("swin"), "volume")
    n_attn = res["launches"]["window_attention"]
    assert res["forwards"] > 0 and n_attn == SWIN_BLOCKS * res["forwards"], \
        f"{n_attn} window-attention launches in {res['forwards']} forwards"
    launches["9"] = res["launches"]

    say("[phase 10] the probes: copy-scale, tensor-core dots, the conv's "
        "phase ladder")
    t_probes = time.perf_counter()
    launches["10"] = phase_probes(device, record)
    say(f"  phase 10 took {time.perf_counter() - t_probes:.1f} s; launches "
        f"{ {k: launches['10'][k] for k in KERNELS if launches['10'][k]} }")

    jax_mods = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "cbim_tpu")]
    assert not jax_mods, f"the port loaded JAX modules: {jax_mods[:5]}"

    kernels = []
    for name, (src, rep) in KERNELS.items():
        keys = (name, DGRAD[name]) if name in DGRAD else (name,)
        by_phase = {ph: {k: counts[k] for k in keys}
                    for ph, counts in launches.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(sum(c.values()) for c in by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": record["errors"][name], **record[name]})
    say(f"  total {time.perf_counter() - t_start:.1f} s")
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
