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
   each kernel's time (the 3^3 backward's at the record's case only) beside
   its plain version's and the one PyTorch call
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
   cores: 3xTF32 in fp32, bf16 mma in bf16) at the Swin zoo's shapes
   (nnFormer's N = 512 at D = 32 on the fp32 split-on-load staging, and
   VT-UNet's first stage at the BCV recipe among them), with and without
   a shifted-window mask, beside ``F.scaled_dot_product_attention`` on the
   same bias, in fp32 its error against an fp64 evaluation at most twice
   SDPA fp32's, SwinUNETR's three shapes, the split-on-load shape and
   VT-UNet's, nnFormer's (N = 64, D = 32) and SwinUnet's (N = 49, D = 32,
   2D region ids) first stages timed; the fused preact conv's kernels at
   the 3^3 conv shapes, relu and gelu, on the route of ``conv3d_route``
   (timed at the JSON records' cases only; at widths of
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
   exactly where it enters each output, finite elsewhere; and
   ``torch.library.opcheck`` of every ``cbim`` custom op (the kernels'
   entry points: its schema, its fake implementation's shapes, dtypes and
   strides against the kernel's output, the op under AOT dispatch) at one
   shape on the card, after the same on CPU tensors beside the build;
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
4d. a small SwinUNETR (feature size 48, on 2 x 32^3), card
   (window-attention kernel) vs CPU (plain version): softmax outputs; then
   one fp32 train step on 2 x 32^3, card vs CPU, the loss and every
   gradient compared, with no window-attention launch (training mode takes
   the autograd route);
4e. ``validate`` (``cbim_tpu_torch.training.validation``) of phase 4's
   small MedFormer-3D, same seeded weights, on one 72 x 64 x 80
   Synthetic3D test volume by 64^3 sliding window, card (fp32: the TF32
   forwards) vs CPU: the label maps agree on at least 99.9 % of voxels and
   each class's Dice within 1e-3;
4f. a small VT-UNet (embedding 96, head dim 32, on 2 x 32 x 64 x 64),
   card vs CPU: the eval softmax through the kernel, 19 launches (7
   encoder blocks, 6 decoder blocks attending to themselves and to the
   encoder's cache); then one fp32 train step with ``drop_path_rate`` 0,
   the loss and every gradient compared, no window-attention launch;
4g. a small nnFormer (embedding 48, head dim 16, the reference's windows,
   on 2 x 32 x 64 x 64), card vs CPU: every head's eval softmax through the
   kernel, 14 launches (8 encoder blocks, 6 decoder blocks, the first of
   each decoder stage attending from the upsampled path to the skip's k
   and v); then one fp32 train step with ``drop_path_rate`` 0, the loss
   and every gradient compared, no window-attention launch;
4h. the same for a SwinUnet-2D at the reference's width (embedding 96,
   head dim 32, on 2 x 128^2): 22 launches a forward (12 encoder blocks,
   10 decoder blocks), 2D region ids;
4u. the rest of the 3D zoo at small widths (``SMALL_ZOO``: UNet-3D,
   UNet++-3D, AttentionUNet-3D, VNet and UNETR on 2 x 32^3), card vs CPU:
   the eval softmax, every routed 3^3 conv one forward of its route
   (``conv3d_same_fwd_tf32``; UNet++'s two convs of the 1-channel input
   the CUDA-core ``conv3d_same_fwd``) and every InstanceNorm
   (AttentionUNet's gate norms included) one ``inorm_stats`` and one
   ``inorm_apply`` a forward, none for VNet and UNETR (cuDNN convs, batch
   and affine instance norms); then one fp32
   train step, the loss and every gradient compared, on the TF32 forward,
   dgrad and wgrad and the norm backward kernels for the UNet family,
   VNet's whole-channel dropout masks fixed on both sides;
4z. the 2D zoo at small widths (``SMALL_ZOO_2D``: UNet-2D, UNet++-2D,
   AttentionUNet-2D, DAUNet with its attention gains drawn, and TransUNet
   at hidden 96 with 2 layers, on 2 x 64^2, ``conv2d_kernel`` on), card vs
   CPU: the eval softmax, every routed 3x3 conv one forward of its route
   (``conv2d_same_fwd_tf32``; UNet++'s 1-channel first conv the CUDA-core
   ``conv2d_same_fwd``) and every gate InstanceNorm one ``inorm_stats`` and
   ``inorm_apply`` a forward, none for TransUNet; then one fp32 train step,
   the loss and every gradient compared, each routed conv's forward, dgrad
   and wgrad (the 1-channel conv's no dgrad) and each gate norm's backward
   pair exactly once;
4x. the blocks and options since A6c at small widths (``SMALL_OPTIONS``):
   UNet-3D with FusedMBConv blocks and LayerNorm, phase 4's MedFormer-3D
   with SiLU, ``proj_type: linear`` and dropouts of 0.1 (masks fixed on
   both sides), UNet-2D with Bottleneck blocks (``conv2d_kernel``), card
   vs CPU: the eval softmax, every routed conv one forward of its route and
   every InstanceNorm one stats and one apply (SiLU after, unfused); one
   fp32 train step, the loss and every gradient compared, each routed conv
   its forward, dgrad and wgrad and each norm its backward pair; then a
   ConvNeXtBlock alone (no factory builds it): its output and one step's
   gradients, card vs CPU, no kernel launch;
5. serving: the full-width AMOS-CT MedFormer-3D with seeded random weights
   serves a synthetic NIfTI request (``REQUESTS``: 160 x 256 x 256)
   through ``cbim_tpu_torch.prediction.main``; every forward kernel must have
   launched, fp32: every 3^3 conv one ``conv3d_same_fwd_tf32`` launch, 20
   a forward, and no other 3^3 kernel (the CUDA-core fp32 forward launches
   on no full-width path: phase 3 holds it at every conv case and the
   ragged 20 -> 36 takes it, phase 10's ladder is its code);
5b. the request again with ``conv_na: true``: every conv of the
   BasicBlocks is one ``conv3d_same_na_fwd_tf32`` launch, 20 a forward,
   and no other 3^3 kernel launches; the label map agrees with phase 5's;
5r. the full-width AMOS-CT ResUNet-3D (``configs/amos_ct/resunet_3d.yaml``:
   base 32, BasicBlock, InstanceNorm, 3^3, 16 classes, 128^3 window, fp32)
   with seeded weights serves phase 5's request: per forward 25
   ``conv3d_same_fwd_tf32`` (RESUNET_CONVS) and 42 ``inorm_stats`` and
   ``inorm_apply`` (RESUNET_NORMS) launches, no other 3^3 kernel;
5e. phase 5's model frozen with ``torch.export`` by the export CLI
   (``python -m cbim_tpu_torch.tools.export_model``, in two processes
   started after the build, tracing on the card without a launch): the
   window forward at the serving window batch (6) and the sliding-window
   program of EXPORT_VOLUME (112 x 128 x 192: padded on z, two window
   groups); each artifact loaded from its bytes and run beside the live
   engine on the same input: probabilities within EXPORT_ATOL, the
   launches of every kernel equal (20 ``conv3d_same_fwd_tf32`` and 106
   each of ``inorm_stats`` and ``inorm_apply`` a forward); the export and
   load seconds, the bytes, and the loaded program's seconds beside the
   live engine's;
5p. phase 5's model with ``proj_type: linear`` (1x1 B-MHA and
   PatchMerging projections, FusedMBConv feed-forwards) served with
   ``window_fusion: gaussian``: 20 ``conv3d_same_fwd_tf32`` and one
   ``inorm_stats`` and ``inorm_apply`` per InstanceNorm a forward, no other
   3^3 kernel; the share of voxels labelled as the same model labels them
   under uniform fusion (printed, not held);
6. training: the flagship recipe (``bench.py``: full-width MedFormer-3D,
   GELU, 128^3 crops, batch 2, bf16 autocast, remat of every stage, AdamW,
   EMA) trains a few steps on the synthetic corpus through
   ``cbim_tpu_torch.train.main``; every kernel, backward ones included,
   must have launched, and every loss must be finite.  Launch counts
   include the forward that remat recomputes in the backward pass: per
   step 40 ``conv3d_same_fwd_tc``, 20 ``conv3d_dgrad_tc`` and 20
   ``conv3d_wgrad_tc``, and no CUDA-core 3^3 launch;
6d. data parallelism: phase 6's recipe, from its seed, for 2 steps
   through ``cbim_tpu_torch.train.main`` under a one-process NCCL group
   (``parallel.initialize_distributed`` as for one rank of ``torchrun``):
   the live model trains wrapped in ``DistributedDataParallel`` (every
   step's forward goes through it), the loss and its gradient are the
   global batch's; the losses within 1e-3 relative of phase 6's first
   two, each step's launches of every kernel equal to phase 6's per
   step; sec/step and peak memory beside phase 6's.  Then phase 4e's small
   MedFormer-3D and test volume in the same group: ``sliding_window_sharded``
   at W = 1 against ``sliding_window`` (1e-6) and ``validate(mesh=...)``
   against ``validate`` (Dice 1e-6, distances 1e-9 relative);
6s. the 'spatial' mesh axis: phase 6's recipe, from its seed, for 2
   steps H-sharded over two ranks at ``mesh_shape`` [1, 2]
   (``cbim_tpu_torch.tools.spatial_train``: two processes on the one
   card, gloo over the card's tensors, since NCCL refuses two ranks on one
   card): each rank trains on its 64-row slab of H with halo-exchanging
   3^3 conv kernels and InstanceNorm kernels whose statistics are merged
   over the ranks; the losses within 1e-3 relative of phase 6's first two,
   every rank's per-step launches of the norm kernels and the tensor-core
   3^3 forward, dgrad and wgrad printed (each above 0); sec/step and each
   rank's peak memory beside phase 6's.  The ranks start before phase 5
   (their processes, imports and contexts come up beside phases 5-6p) and
   train as phase 6v's host distances start, where the main process leaves
   the card idle; their results are read after 6v;
6b. the same recipe with ``conv_na: true``: per step 40
   ``conv3d_same_na_fwd_tc`` (remat incl.), 20 ``conv3d_wgrad_na_tc`` and
   20 ``conv3d_dgrad_tc`` launches, no other 3^3 launch (the CUDA-core
   fused pair none); sec/step and peak memory beside phase 6's;
6p. the flagship recipe with ``proj_type: linear``, ``attn_drop`` and
   ``proj_drop`` 0.1 for 3 steps: every loss finite, the dropouts drew
   (remat's recompute replays the forward's masks), per step the same
   40 + 20 + 20 tensor-core 3^3 launches as phase 6; sec/step and peak
   memory beside phase 6's;
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
   kits`` in fp32 (the CLI's default: no ``--amp``) at batch 2 for 3 steps
   on 5 HU-like int16 NIfTI cases the script writes (about 1.25x the crop,
   fold 0 of 5), fed from host windows in pinned memory
   (``device_cache: false``: a real KiTS corpus is far over the cache's
   4 GB); every loss finite, and per step 32 ``conv3d_same_fwd_tf32``
   (remat incl.), 16 ``conv3d_dgrad_tf32`` and 16 ``conv3d_wgrad_tf32``
   launches, no tensor-core and no CUDA-core 3^3 launch; every batch's
   host windows copied by the native batch assembler
   (``data/native.py``); sec/step (the step after warm-up), peak memory,
   the batches' time alone and the host copy alone with the assembler and
   with numpy;
6kn. the same recipe with ``conv_na: true`` for 3 steps: every one of its
   16 kernel convs fused, per step 32 ``conv3d_same_na_fwd_tf32`` (remat
   incl.), 16 ``conv3d_dgrad_tf32`` and 16 ``conv3d_wgrad_na_tf32``
   launches and no other 3^3 launch (the CUDA-core ``conv3d_wgrad_na``
   none); sec/step beside phase 6k's;
6a. the ACDC-3D recipe (``configs/acdc/medformer_3d.yaml``: 16 x 192 x 192
   crops, 4 classes, fp32, batch 2) for 3 steps on 6 written cases of two
   frames: the pipeline took the device cache and its full-volume path (one
   full-volume resample a step), every loss finite; sec/step (the step
   after warm-up) and the batches' time alone;
6r. the AMOS-CT ResUNet-3D recipe as shipped (fp32, no remat in the UNet
   family) trains 4 steps at batch 2 on phase 6's synthetic corpus: every
   loss finite, per step 25 ``conv3d_same_fwd_tf32``, 25
   ``conv3d_dgrad_tf32`` and 25 ``conv3d_wgrad_tf32`` launches and 42 of
   each norm kernel's forward stats and backward pair, no other 3^3
   launch; sec/step and peak memory;
6x. the same recipe with ``block: Bottleneck`` (mid widths 16-160) for 3
   steps: every loss finite, per step each of its 3^3 convs up to 128 wide
   one ``conv3d_same_fwd_tf32``, ``conv3d_dgrad_tf32`` and
   ``conv3d_wgrad_tf32`` launch (the 1-channel stem's and the wider convs
   on cuDNN), each InstanceNorm its forward and backward kernels, no other
   3^3 launch; sec/step and peak memory;
7. 2D serving: the full-width ACDC MedFormer-2D with seeded random weights
   serves a synthetic cine-MR NIfTI request through
   ``cbim_tpu_torch.prediction.main --dimension 2d`` (every slice of a
   volume is the batch at each window position); fp32: every 3x3 kernel
   conv one ``conv2d_same_fwd_tf32`` launch, 14 a forward, and no other
   3x3 kernel; then the same request with ``conv2d_kernel`` off (cuDNN
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
7s. SwinUnet-2D serving: ``configs/acdc/swinunet_2d.yaml`` (224^2, 4
   classes, fp32) with seeded random weights serves phase 7's request
   through ``prediction.main --model swinunet --dimension 2d``;
   22 window-attention launches per forward;
8s. the ACDC SwinUnet recipe as shipped (fp32, stochastic depth 0.1)
   trains one epoch of 4 batch-32 steps on ``Synthetic2D``: every loss
   finite, DropPath drew its masks, no window-attention launch in a step;
7r. the full-width ACDC ResUNet-2D (``configs/acdc/resunet_2d.yaml``: base
   32, BasicBlock, BatchNorm, 4 classes, 256^2, fp32, ``conv2d_kernel``)
   with seeded weights serves phase 7's request: 25
   ``conv2d_same_fwd_tf32`` launches a forward (ACDC_RESUNET_CONVS) and no
   other 3x3 kernel;
8r. the ACDC ResUNet-2D recipe as shipped (fp32, ``conv2d_kernel``)
   trains one epoch of 4 batch-32 steps on ``Synthetic2D``: every loss
   finite, per step 25 ``conv2d_same_fwd_tf32``, ``conv2d_dgrad_tf32`` and
   ``conv2d_wgrad_tf32`` launches and no other 3x3 kernel;
7t. the full-width ACDC TransUNet (``configs/acdc/transunet_2d.yaml``:
   R50-ViT-B/16, 256^2, fp32) with seeded weights serves phase 7's
   request: no kernel launches (cuDNN's convs, torch's norms and GEMMs, as
   XLA's in JAX);
9. Swin serving: the full-width BCV SwinUNETR (``configs/bcv/
   swin_unetr_3d.yaml``: 14 classes, feature size 48, 128^3 window, fp32)
   with seeded random weights serves phase 5's request through
   ``cbim_tpu_torch.prediction.main --model swin_unetr``; the window-
   attention kernel must have launched once per Swin block of every
   forward, 6 per forward;
9t. the BCV SwinUNETR recipe as a user trains it
   (``configs/bcv/swin_unetr_3d.yaml`` as shipped: 128^3 crops, fp32, the
   BCV augmentation) through ``cbim_tpu_torch.train.main --model
   swin_unetr`` at batch 2 for 2 steps on 5 HU-like NIfTI cases the
   script writes; every loss finite, no window-attention launch in a
   step; sec/step and peak memory;
9u. the full-width BCV VT-UNet (``configs/bcv/vtunet_3d.yaml``: patch 4,
   64 x 128 x 128 window, fp32) with seeded random weights serves phase
   9's request; 19 window-attention launches per forward;
9ut. the BCV VT-UNet recipe as shipped (stochastic depth 0.1) trains 2
   steps at batch 2 on phase 9t's cases: every loss finite, DropPath drew
   its masks, no window-attention launch in a step;
9n. the full-width BCV nnFormer (``configs/bcv/nnformer_3d.yaml``:
   embedding 192, patch (2, 4, 4), 128^3 window, three heads, fp32) with
   seeded random weights serves phase 9's request (head 0); 14
   window-attention launches per forward (N = 512 at stage 2 and its
   decoder stage, on the fp32 split-on-load staging; N = 64 elsewhere);
9nt. the BCV nnFormer recipe as shipped (deep supervision, stochastic
   depth 0.2) trains 2 steps at batch 2 on phase 9t's cases: every loss
   finite, DropPath drew its masks, no window-attention launch in a step;
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

The CPU references of phases 4-4z (each small model's eval softmax and
train step on the CPU's plain versions; 4z's TransUNet step also in fp64)
are computed in a thread beside phases 3 and 3a, where the host's cores
are idle, and read by those phases; phase 4x's beside phases 4-4z; the
same thread then writes the serving phases' requests and the KiTS,
ACDC-3D and BCV corpora, once.

Each of phases 4e, 4u, 4z, 4x and 5-10 (5b, 5e, 5r, 5p, 6s (in each
rank), 6b, 6p, 6v, 6k, 6kn,
6a, 6r, 6x, 7b, 8b, 8f, 8v, 7s, 8s, 7r, 8r, 7t, 9t, 9u, 9ut, 9n and 9nt
included) sets
the launch counters to 0 just before it and reads them just after.  The
last three
lines are the card's name and power limit, the kernels' JSON record
(launches by phase, errors, times, the bound from the recorded shape's
FLOPs and bytes) and ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--profile DIR]

``--profile DIR`` also traces the steady steps of phases 6, 6b, 6p, 6k,
6kn, 6a, 6r, 6x, 8, 8b, 8f and 8r with the trainer's profiler hook
(``profile_dir``), and the requests of phases 5, 5b, 5r, 5p, 9, 9n, 7r
and 7t served a second time, after the timed run:
DIR/<phase>/kernels.txt and summary.json, and the top kernels by device
time are printed; for 5, 5b, 5r and 5p also the 3^3 forwards' shapes and
counts.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
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
#: B-MHA projections and MBConvs of down2/up2 and down4 (the widest and
#: the narrowest map; down3/up1's two middle shapes were dropped to keep
#: the script within its time)
DEPTHWISE2D_CASES = [(32, 64, 64, 128), (32, 16, 16, 1024)]

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
            ((16, 24, 512, 16), (16, 16, 32), (8, 8, 8)),
            # nnFormer's stage 2 at D = 32: the fp32 kernel's split-on-load
            # staging (its TF32 planes would take 264 KB)
            ((16, 24, 512, 32), (16, 16, 32), (8, 8, 8)),
            # VT-UNet's first stage at the BCV recipe (64 x 128 x 128,
            # patch 4: a 16 x 32 x 32 token grid padded to 21 x 35 x 35),
            # batch 2
            ((150, 3, 343, 32), (21, 35, 35), (7, 7, 7)),
            # nnFormer's first stage at the BCV recipe (128^3, patch
            # (2, 4, 4): a 64 x 32 x 32 token grid, windows of 4), batch 2
            ((2048, 6, 64, 32), (64, 32, 32), (4, 4, 4)),
            # SwinUnet's first stage at the ACDC recipe (224^2, patch 4: a
            # 56^2 grid, windows of 7, 2D region ids; N = 49 pads to 64
            # keys), a training batch of 32 slices
            ((2048, 3, 49, 32), (56, 56), (7, 7))]
#: the case of the JSON record: SwinUNETR's first stage, shifted, fp32
WA_RECORD = ((1000, 3, 343, 16), True, "float32")
#: the split-on-load staging's case, kept in the record beside it
WA_SPLIT_RECORD = ((16, 24, 512, 32), True, "float32")
#: the shapes whose kernel, SDPA and plain times phase 3 takes: SwinUNETR's
#: three stages, the split-on-load shape, VT-UNet's, nnFormer's and
#: SwinUnet's first stages (the other shapes are checked and not timed,
#: which keeps the script within its budget)
WA_TIMED = ((1000, 3, 343, 16), (125, 6, 343, 16), (27, 12, 343, 16),
            (16, 24, 512, 32), (150, 3, 343, 32), (2048, 6, 64, 32),
            (2048, 3, 49, 32))
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
    epochs=1, iter_per_epoch=4, print_freq=1, val_freq=2)
TRAIN_BATCH = 2
#: phase 6v: the flagship recipe on five 130^3 volumes, fold 0 of 5 (one
#: test volume), two steps, then the EMA model's evaluation by 128^3
#: sliding window: 8 windows (two a side: starts 0 and 2), 2 forwards at
#: the auto window batch of 4; the host distances, most of the phase,
#: scale with the volume (17-24 s of them at 160^3, 8-10 at 130^3), and
#: 130^3 is about the least it can be: a test volume is padded to the crop
#: plus 2 in y and x (``pad_to_training_size``), 130 x 130 x 130 for a 130
#: x 64 x 64 one (PR 20, call 1)
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
#: phase 6d: the flagship recipe under a one-process NCCL group, 2 steps
#: from phase 6's seed (the least that shows a step after an update, for
#: the script's time budget); its losses against phase 6's (the same
#: kernels on the same batches; the group's sums of one rank and DDP's mean
#: over one rank change the loss only by fp32 rounding, bf16's
#: nondeterminism aside)
FLAGSHIP_DDP = dict(FLAGSHIP, iter_per_epoch=2)
DDP_LOSS_RTOL = 1e-3
#: phase 6d: the sharded sweep at W = 1 against the unsharded one (the
#: same windows in the same groups and order), validate's Dice and
#: distances with the group's float64 sums against the one-process means
DDP_PROB_ATOL, DDP_DICE_ATOL, DDP_DISTANCE_RTOL = 1e-6, 1e-6, 1e-9
#: phase 6s: the flagship recipe H-sharded over two ranks that share the
#: one card ('spatial' axis of 2, gloo over the card's tensors: NCCL
#: refuses two ranks on one card), 2 steps from phase 6's seed; its losses
#: against phase 6's within DDP_LOSS_RTOL (bf16, another order of the
#: sums over H), and every rank launches each of SPATIAL_KERNELS every step
FLAGSHIP_SPATIAL = dict(FLAGSHIP_DDP, mesh_axes=["data", "spatial"],
                        mesh_shape=[1, 2])
SPATIAL_RANKS = 2
SPATIAL_KERNELS = ("inorm_stats", "inorm_apply", "inorm_bwd_stats",
                   "inorm_bwd_apply") + TC_CONV_KERNELS
#: seconds phase 6s's ranks may take, start-up included
SPATIAL_TIMEOUT = 300
#: phase 6p: the flagship recipe with ``proj_type: linear`` and dropouts
#: of 0.1 (the map-to-feature attention and the feature output of every
#: B-MHA block), 3 steps
FLAGSHIP_LINEAR = dict(FLAGSHIP, proj_type="linear", attn_drop=0.1,
                       proj_drop=0.1, iter_per_epoch=WARMUP_STEPS + 1)

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
#: the 3D serving phases' request (z, y, x shape, z, y, x spacing) at
#: target spacing 1.5 mm: the AMOS evaluation volume of
#: tools/bench_infer.py.  A second request, resampled to 160 x 253 x 253
#: (its host resampling, 5 s, and no other model shape), left phase 5 to
#: make room for phases 4u, 5r and 6r within the script's time
REQUESTS = [((160, 256, 256), (1.5, 1.5, 1.5))]
TARGET_SPACING = "1.5,1.5,1.5"

#: the model and inference keys of configs/amos_ct/resunet_3d.yaml (phases
#: 5r and 6r): ResUNet-3D, base 32, BasicBlock, InstanceNorm, 3^3
#: everywhere, 16 classes, 128^3 (the factory passes no act: ReLU), fp32
RESUNET = dict(
    dataset="amos_ct", model="resunet", dimension="3d", classes=16,
    in_chan=1, base_chan=32, block="BasicBlock", down_scale=[[2, 2, 2]] * 4,
    kernel_size=[[3, 3, 3]] * 5, norm="in", training_size=[128, 128, 128],
    sliding_window=True, window_size=[128, 128, 128])
#: its ConvNormActs on the 3^3 kernel route (C_in <= 192, C_out <= 128,
#: widths multiples of 8: the TF32 route in fp32): 2 in inc, 5 in down1
#: and down2, 3 in up2 (the 384-wide concat takes cuDNN), 5 in up3 and up4;
#: and its InstanceNorms, one per ConvNormAct, all on the norm kernels
RESUNET_CONVS = 25
RESUNET_NORMS = 42
#: phase 6r: the recipe as shipped on phase 6's synthetic corpus (3 x
#: 192^3, all three training volumes), fp32, batch 2, RESUNET_STEPS steps
RESUNET_STEPS = WARMUP_STEPS + 2
#: phase 6x: the recipe with Bottleneck blocks (mid widths 16-160: the
#: 3^3 convs up to 128 wide on the TF32 route), 3 steps
RESUNET_BOTTLENECK = dict(RESUNET, block="Bottleneck")
BOTTLENECK_STEPS = WARMUP_STEPS + 1
#: phase 5p: AMOS-CT MedFormer-3D with ``proj_type: linear`` (the B-MHA's
#: and PatchMerging's 1x1 projections, FusedMBConv feed-forwards) served
#: with Gaussian window fusion
LINEAR_GAUSSIAN = dict(AMOS, proj_type="linear", window_fusion="gaussian")
#: phase 4u: the rest of the 3D zoo at small widths (base 8: widths 8-80,
#: multiples of 8, so the UNet family's 3^3 convs take the TF32 route;
#: UNETR at hidden 96, 3 heads, MLP 192, feature size 16), card vs CPU on
#: 2 x 32^3: UNet with SingleConv blocks, UNet++ and AttentionUNet with
#: their recipes' BasicBlocks; VNet's dropout masks fixed on both sides
ZOO_BASE = dict(dataset="synthetic", dimension="3d", classes=4, in_chan=1,
                base_chan=8, block="BasicBlock", norm="in",
                down_scale=[[2, 2, 2]] * 4, kernel_size=[[3, 3, 3]] * 5,
                training_size=[32, 32, 32])
SMALL_ZOO = (("UNet-3D", dict(ZOO_BASE, model="unet", block="SingleConv")),
             ("UNet++-3D", dict(ZOO_BASE, model="unet++")),
             ("AttentionUNet-3D", dict(ZOO_BASE, model="attention_unet")),
             ("VNet", dict(ZOO_BASE, model="vnet")),
             ("UNETR", dict(ZOO_BASE, model="unetr", feature_size=16,
                            hidden_size=96, mlp_dim=192, unetr_num_heads=3)))
SMALL_ZOO_SHAPE = (2, 1, 32, 32, 32)
#: VNet's dropouts a forward (phase 4u's fixed masks cycle through them)
VNET_DROPOUTS = 8

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
#: its input: 2 x 32^3 (windows of 7 padded to 21^3 and 14^3 with shifted
#: masks at the first two stages, batch 2 so the mask's window index wraps
#: at b % nW; the third stage's window shrinks to 4^3 and its bias-table
#: index to [:64, :64]); 2 x 64^3, which also shifts the third stage, was
#: dropped to keep the script within its time
SMALL_SWIN_SHAPES = [(2, 1, 32, 32, 32)]
#: its train step's batch (phase 4d): the training route, no kernel
SMALL_SWIN_STEP = (2, 1, 32, 32, 32)
#: a VT-UNet at the BCV width (embedding 96: head dim 32 at every stage),
#: cut in input size, no stochastic depth (phase 4f): 32 x 64 x 64 is an 8
#: x 16 x 16 token grid, padded windows at stage 0 and windows shrunk to
#: (7, 4, 4) and (7, 2, 2) below, batch 2 so the region ids wrap
SMALL_VT = dict(dataset="synthetic", model="vtunet", dimension="3d",
                classes=14, in_chan=1, patch_size=[4, 4, 4],
                drop_path_rate=0.0, training_size=[32, 64, 64])
SMALL_VT_SHAPE = (2, 1, 32, 64, 64)

#: the model and inference keys of configs/bcv/swin_unetr_3d.yaml (phase 9)
BCV = dict(dataset="bcv", model="swin_unetr", dimension="3d", classes=14,
           in_chan=1, base_chan=48, training_size=[128, 128, 128],
           sliding_window=True, window_size=[128, 128, 128])
#: window-attention launches per SwinUNETR forward: one per Swin block,
#: depths (2, 2, 2, 0)
SWIN_BLOCKS = 6
#: the model and inference keys of configs/bcv/vtunet_3d.yaml (phase 9u)
BCV_VT = dict(dataset="bcv", model="vtunet", dimension="3d", classes=14,
              in_chan=1, patch_size=[4, 4, 4],
              training_size=[64, 128, 128], sliding_window=True,
              window_size=[64, 128, 128])
#: window-attention launches per VT-UNet forward: 7 encoder blocks, and 6
#: decoder blocks that attend twice (themselves, the encoder's cache)
VT_ATTENTIONS = 19
#: an nnFormer at the synthetic recipe's widths (embedding 48, heads 3-24:
#: head dim 16 at every stage) with the reference's windows (4, 4, 8, 4),
#: cut in input size, no stochastic depth (phase 4g): 32 x 64 x 64 crops
#: are a 16^3 token grid, shifted windows of 4 at stages 0 and 1, windows
#: shrunk to 4 (N = 64) and 2 below; batch 2 so the region ids wrap
SMALL_NN = dict(dataset="synthetic", model="nnformer", dimension="3d",
                classes=14, in_chan=1, embedding_dim=48,
                nnformer_num_heads=[3, 6, 12, 24], drop_path_rate=0.0,
                aux_loss=True, training_size=[32, 64, 64],
                window_size=[32, 64, 64])
SMALL_NN_SHAPE = (2, 1, 32, 64, 64)
#: the model and inference keys of configs/bcv/nnformer_3d.yaml (phase 9n)
BCV_NN = dict(dataset="bcv", model="nnformer", dimension="3d", classes=14,
              in_chan=1, aux_loss=True, training_size=[128, 128, 128],
              sliding_window=True, window_size=[128, 128, 128])
#: window-attention launches per nnFormer forward: 8 encoder blocks, 6
#: decoder blocks (at the BCV crop: N = 512 at stage 2 and its decoder
#: stage, N = 64 elsewhere, D = 32)
NN_ATTENTIONS = 14
#: a SwinUnet at the reference's width (embedding 96: head dim 32 at every
#: stage), cut in input size (phase 4h): 128^2 is a 32^2 token grid,
#: shifted windows of 7 padded to 35^2, 21^2 and 14^2, shrunk to 4^2 at
#: stage 3; batch 2 so the region ids wrap
SMALL_SU = dict(dataset="synthetic", model="swinunet", dimension="2d",
                classes=4, in_chan=1, drop_path_rate=0.0,
                training_size=[128, 128])
SMALL_SU_SHAPE = (2, 1, 128, 128)
#: the model and inference keys of configs/acdc/swinunet_2d.yaml (phases 7s
#: and 8s; validation serves whole images, the CLI a 224^2 window)
ACDC_SU = dict(dataset="acdc", model="swinunet", dimension="2d", classes=4,
               in_chan=1, training_size=[224, 224], sliding_window=False)
#: window-attention launches per SwinUnet forward: 12 encoder blocks and 10
#: decoder blocks (the decoder reuses the encoder's depths)
SU_ATTENTIONS = 22
#: phases 9t, 9ut and 9nt: the BCV recipes as shipped (SwinUNETR: 128^3
#: crops; VT-UNet: 64 x 128 x 128, stochastic depth 0.1; nnFormer), fp32,
#: batch 2, BCV_STEPS steps (the median is the second's: 4 before PR 20)
#: on 5 written HU-like cases (abdominal CT resampled to about 1.5
#: mm: 140-150 slices of 180-190^2), fold 0 of 5; val_freq (50, 10) is
#: above the one epoch
BCV_CASES = [((144, 184, 184), (1.5, 1.5, 1.5)),
             ((140, 190, 180), (1.5, 1.5, 1.5)),
             ((150, 180, 186), (1.5, 1.5, 1.5)),
             ((146, 186, 190), (1.5, 1.5, 1.5)),
             ((142, 182, 184), (1.5, 1.5, 1.5))]
BCV_STEPS = 2
BCV_NAMES = [f"img{i:04d}" for i in range(1, len(BCV_CASES) + 1)]

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
#: the 2D serving phases' cine-MR request (z, y, x shape, z, y, x
#: spacing) at the target in-plane spacing 1.5625 mm: 224 x 240, padded to
#: 258^2: four overlapping 256^2 windows.  A second request, resampled
#: from 1.25 mm to 16 x 304 x 336 (its host resampling, 1.2-1.4 s a phase,
#: and no other model shape), left phases 7, 7b and 7s in PR 20 to make
#: room for phases 4x, 5p, 6p and 6x within the script's time
REQUESTS_2D = [((10, 224, 240), (10.0, 1.5625, 1.5625))]
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
#: phase 8s: configs/acdc/swinunet_2d.yaml as shipped on Synthetic2D
#: (224^2: 280^2 slices of 6), fold 0 of 5 of SU_TRAIN_CASES cases: 22
#: training cases, 132 slices, SU_STEPS (4) steps at batch 32; its val_freq
#: (10) is above the one epoch
SU_TRAIN_CASES = 27
SU_STEPS = 6 * 22 // TRAIN2D_BATCH
#: phase 8v: the ACDC recipe on 10 cases, fold 0 of 5 (48 slices: one step
#: at batch 32), then the EMA model's evaluation of the 2 test volumes (6
#: slices each, centre-cropped to 256^2: one whole-image forward a volume)
ACDC_VAL = dict(ACDC_TRAIN, synthetic_cases=10, val_freq=1)

#: the model keys of configs/acdc/resunet_2d.yaml (phases 7r and 8r):
#: ResUNet-2D, base 32, BasicBlock, BatchNorm (the factory passes no norm),
#: 4 classes, 256^2, whole-image validation; on the 3x3 kernel route
ACDC_RESUNET = dict(dataset="acdc", model="resunet", dimension="2d",
                    classes=4, in_chan=1, base_chan=32, block="BasicBlock",
                    training_size=[256, 256], sliding_window=False,
                    conv2d_kernel=True)
#: its ConvNormActs on the 3x3 kernel route (C_in <= 192, C_out <= 192,
#: widths multiples of 8: the TF32 route in fp32): 2 in inc, 5 in down1 and
#: down2 (a block's 3x3 shortcut where the width changes), 3 in up2 (its
#: first block's conv1 and shortcut read the 256-wide concat: cuDNN), 5 in
#: up3 and up4.  Phase 8r trains the recipe as shipped on Synthetic2D, fold
#: 0 of 5 of SU_TRAIN_CASES cases: SU_STEPS steps at batch 32
ACDC_RESUNET_CONVS = 25
#: the model keys of configs/acdc/transunet_2d.yaml (phase 7t): the
#: R50-ViT-B/16 at 256^2 (a 16^2 token grid), 4 classes
ACDC_TRANSUNET = dict(dataset="acdc", model="transunet", dimension="2d",
                      classes=4, in_chan=1, training_size=[256, 256],
                      sliding_window=False)
#: phase 4z: the 2D zoo at small widths, card vs CPU on 2 x 64^2 with
#: ``conv2d_kernel`` on: base 8 (widths 8-128, multiples of 8: the TF32 3x3
#: route; UNet++'s 1-channel first conv the CUDA-core one), BatchNorm;
#: DAUNet with its attention gains drawn (``seeded_model``); TransUNet's R50
#: at its fixed widths and a ViT at hidden 96, 3 heads, MLP 192, 2 layers,
#: dropout 0
ZOO2D_BASE = dict(dataset="synthetic", dimension="2d", classes=4, in_chan=1,
                  base_chan=8, training_size=[64, 64], conv2d_kernel=True)
SMALL_ZOO_2D = (
    ("UNet-2D", dict(ZOO2D_BASE, model="unet", block="SingleConv")),
    ("UNet++-2D", dict(ZOO2D_BASE, model="unet++")),
    ("AttentionUNet-2D", dict(ZOO2D_BASE, model="attention_unet")),
    ("DAUNet", dict(ZOO2D_BASE, model="daunet", block="BasicBlock")),
    ("TransUNet", dict(ZOO2D_BASE, model="transunet", hidden_size=96,
                       mlp_dim=192, num_layers=2, transunet_num_heads=3,
                       dropout_rate=0.0)))
SMALL_ZOO_2D_SHAPE = (2, 1, 64, 64)
#: phase 4x: the blocks and options the port takes since A6c at small
#: widths, card vs CPU: UNet-3D with FusedMBConv blocks and LayerNorm (its
#: 3^3 expansions on the TF32 route, no InstanceNorm), phase 4's
#: MedFormer-3D with SiLU (the InstanceNorm kernels with act none, SiLU
#: after), ``proj_type: linear`` and dropouts of 0.1 (masks fixed on both
#: sides; no remat, so one forward draws them once), and UNet-2D with
#: Bottleneck blocks on the 3x3 kernel route (their mid width 4 at base 8
#: takes the CUDA-core route); (name, config, input shape: batch 1, their
#: CPU references computed beside phase 3 at about 3 s each)
SMALL_OPTIONS = (
    ("UNet-3D FusedMBConv LN",
     dict(ZOO_BASE, model="unet", block="FusedMBConv", norm="ln"),
     (1, 1, 16, 32, 32)),
    ("MedFormer-3D linear SiLU dropout",
     dict(SMALL, act="silu", proj_type="linear", attn_drop=0.1,
          proj_drop=0.1, remat=False), (1, 1, 32, 32, 32)),
    ("UNet-2D Bottleneck",
     dict(ZOO2D_BASE, model="unet", block="Bottleneck"), (1, 1, 64, 64)))
#: and a ConvNeXtBlock alone (7^3 depthwise, 32 channels: the residual),
#: which no factory builds: its input (B, C, D, H, W)
CONVNEXT_SHAPE = (2, 32, 16, 16, 16)

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
KITS_STEPS = WARMUP_STEPS + 1
#: phase 6kn: the same recipe with ``conv_na: true``, every one of its 16
#: kernel convs a fused preact conv (both the step after warm-up: 6k's 4
#: went to make room for phases 4u, 5r and 6r, and the third of 6k's and
#: 6kn's 4 for phases 4x, 5p, 6p and 6x in PR 20)
KITS_NA_STEPS = WARMUP_STEPS + 1
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
#: (the step after warm-up: cut from 6 to 4 and in PR 20 to 3 to keep the
#: script within its time)
ACDC3D_STEPS = WARMUP_STEPS + 1
ACDC3D_NAMES = [f"patient{i:03d}" for i in range(1, len(ACDC3D_CASES) + 1)]
#: phase 5e: the sliding-window artifact's raw volume (z, y, x) under the
#: 128^3 window: padded on z, two unique windows along x, swept one window
#: a group (two groups), and the artifacts' probabilities against the live
#: engine's (the same kernels in the same order)
EXPORT_VOLUME = (112, 128, 192)
EXPORT_SW_BATCH = 1
EXPORT_ATOL = 1e-5
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
    """Enough calls for ~25 ms of work (50 before PR 20, which halved it to
    make room for its phases; CUDA events time 25 ms to well under 0.1 %),
    at least 3."""
    return max(3, min(200, int(25 * per_ms / max(flops_or_bytes, 1.0))))


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
            # the plain versions (3-8x the kernels' time) at a quarter of
            # the repeats, as the fused pair's, to keep the script within
            # its time
            st_plain = cuda_ms(lambda: fused_norm.inorm_stats_plain(x, eps),
                               plain_iters(n))
            ap_ms = cuda_ms(lambda: fused_norm.inorm_apply(x, pmean, prstd, act), n)
            ap_plain = cuda_ms(
                lambda: fused_norm.inorm_apply_plain(x, pmean, prstd, act),
                plain_iters(n))
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
            # timed at the record's case only (its times are the JSON
            # record's; the rest are checked, which keeps the script
            # within its time)
            timed = case == CONV_RECORD
            xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            if timed:
                dx_ms = cuda_ms(lambda: conv3d.conv3d_dgrad(g, w), n)
                dx_plain = cuda_ms(lambda: conv3d.conv3d_same_plain(g, ws), n)
                dx_lib = cuda_ms(lambda: F.conv3d(gc, ws, padding=1), n)
                dw_ms = cuda_ms(lambda: conv3d.conv3d_wgrad(x, g), n)
                dw_plain = cuda_ms(lambda: conv3d.conv3d_wgrad_plain(x, g),
                                   n)
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
                if timed:
                    cx_ms = cuda_ms(
                        lambda: conv3d._launch_fwd(g, ws, "conv3d_dgrad"), n)
                    core_x = f" CUDA-core {cx_ms:.3f} ms " \
                        f"({cx_ms / dx_ms:.2f}x)"
                del cx
                # and the CUDA-core wgrad
                cw = conv3d._launch_wgrad(x, g)
                torch.cuda.synchronize()
                cew = float((cw - ref_dw).abs().max())
                assert cew <= WGRAD_TOL * sw, f"conv3d_wgrad {dt} {case}"
                errs["conv3d_wgrad"] = max(errs["conv3d_wgrad"], cew)
                if timed:
                    cw_ms = cuda_ms(lambda: conv3d._launch_wgrad(x, g), n)
                    core_w = f" CUDA-core {cw_ms:.3f} ms " \
                        f"({cw_ms / dw_ms:.2f}x)"
                del cw
            times_x = times_w = ""
            if timed:
                times_x = (f" kernel {dx_ms:.3f} ms "
                           f"({flops / dx_ms / 1e9:.1f} TFLOP/s) plain "
                           f"{dx_plain:.3f} ms cuDNN {dx_lib:.3f} ms "
                           f"({dx_ms / dx_lib:.2f}x){core_x}")
                times_w = (f" kernel {dw_ms:.3f} ms "
                           f"({flops / dw_ms / 1e9:.1f} TFLOP/s) plain "
                           f"{dw_plain:.3f} ms cuDNN {dw_lib:.3f} ms "
                           f"({dw_ms / dw_lib:.2f}x){core_w}")
            say(f"  {kx:20s} {dt:8s} {case}: max_abs_err {ex:.3e} "
                f"max_rel_err {ex / sx:.3e} (tol {CONV_TOL[dt]:.1e}){f64}"
                f"{times_x}")
            say(f"  {kw:20s} {dt:8s} {case}: max_abs_err {ew:.3e} "
                f"max_rel_err {ew / sw:.3e} of max|dW| {sw:.1f} "
                f"(tol {WGRAD_TOL:.1e}){f64_w}{times_w}")
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
            # the plain versions at a quarter of the repeats (as above)
            st_plain = cuda_ms(
                lambda: fused_norm.inorm_bwd_stats_plain(x, dy, mean, rstd,
                                                         act), plain_iters(n))
            ap_ms = cuda_ms(lambda: fused_norm.inorm_bwd_apply(
                x, dy, mean, rstd, pred, act), n)
            ap_plain = cuda_ms(lambda: fused_norm.inorm_bwd_apply_plain(
                x, dy, mean, rstd, pred, act), plain_iters(n))
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
    instead of 0 fails.  At the JSON records' cases (NA_RECORD,
    NA_TC_RECORD) each is timed beside the unfused pair of kernels it
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
                # timed at the JSON records' cases only (the checks run at
                # every case), to keep the script within its time
                timed = (case, dt, act) in (NA_RECORD, NA_TC_RECORD)
                if timed:
                    t_fwd = (
                        cuda_ms(lambda: conv3d.conv3d_same_na(
                            x, mean, rstd, w, act), n),
                        cuda_ms(lambda: conv3d.conv3d_same(normed(), w), n),
                        cuda_ms(lambda: conv3d.conv3d_same_na_plain(
                            x, mean, rstd, w, act), plain_iters(n)))
                    t_wg = (
                        cuda_ms(lambda: conv3d.conv3d_wgrad_na(
                            x, mean, rstd, g, act), n),
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
                    if timed:
                        core[kf] = cuda_ms(lambda: conv3d._launch_fwd(
                            x, w, "conv3d_same_na_fwd", na), n)
                        core[kw] = cuda_ms(lambda: conv3d._launch_wgrad(
                            x, g, na), n)
                    del cy, cw
                core_pair = ""
                if route == conv3d.TF32X3 and timed:
                    # the unfused pair on the CUDA-core conv, as served
                    # before the TF32 route
                    core["pair"] = cuda_ms(lambda: conv3d._launch_fwd(
                        normed(), w, "conv3d_same_fwd"), n)
                    core_pair = (f" CUDA-core unfused pair "
                                 f"{core['pair']:.3f} ms")
                for key, times, err, scale, tol, ef in (
                        (kf, t_fwd if timed else None, ey, sy, CONV_TOL[dt],
                         f64 + core_pair),
                        (kw, t_wg if timed else None, ew, sw, WGRAD_TOL,
                         f64_wg)):
                    line = (f"  {key:23s} {dt:8s} {case} {act}: max_abs_err "
                            f"{err:.3e} max_rel_err {err / scale:.3e} of "
                            f"max|ref| {scale:.3f} (tol {tol:.1e}){ef}")
                    if times is not None:
                        ms, pair_ms, plain_ms = times
                        extra = (f" CUDA-core {core[key]:.3f} ms "
                                 f"({core[key] / ms:.2f}x)" if key in core
                                 else "")
                        line += (f" kernel {ms:.3f} ms "
                                 f"({flops / ms / 1e9:.1f} TFLOP/s) unfused "
                                 f"pair {pair_ms:.3f} ms ({ms / pair_ms:.2f}x)"
                                 f" plain {plain_ms:.3f} ms{extra}")
                    say(line)
                    assert err <= tol * scale, f"{key} {dt} {case} {act}"
                    errs[key] = max(errs[key], err)
                if timed:
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
    record["window_attention"] = {}
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
                split = wa.tf32_split_on_load(N, D, dtype)
                line = (f"  window_attention {dt:8s} {(B, H, N, D)} "
                        f"mask={str(masked):5s}"
                        f"{' (split on load)' if split else ''}: "
                        f"max_abs_err {err:.3e} "
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
                        record["window_attention"].update(rec)
                    if ((B, H, N, D), masked, dt) == WA_SPLIT_RECORD:
                        record["window_attention"]["split_on_load"] = rec
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
    """A CPU model with seeded weights; BatchNorm running statistics and
    DAUNet's attention gains drawn from the seed too (their initial 0 and 1
    would leave eval-mode normalisation and the attentions untested)."""
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
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                # DAUNet's attention gains: at their initial 0 the
                # attentions would feed nothing
                p.uniform_(0.5, 1.5, generator=gen)
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


def _ref_key(cfg_dict, shape, *extra) -> tuple:
    """The key of a CPU reference: ``conv_na`` only picks the card's route
    (the plain fused conv is the unfused pair's function) and ``remat``
    recomputes the same function, so both are left out, and one reference
    serves every such variant."""
    return (json.dumps({k: v for k, v in cfg_dict.items()
                        if k not in ("conv_na", "remat")},
                       sort_keys=True, default=str), tuple(shape), *extra)


#: the CPU references of phases 4-4z by ``_ref_key``: eval softmax (seeded
#: weights 1) and train steps (seeded weights 3: loss and fp64 gradients),
#: computed where first asked for, or ahead by ``prefetch_host_work``;
#: and the seeded weights themselves (``seeded_state``)
CPU_EVALS: dict = {}
CPU_STEPS: dict = {}
SEEDED: dict = {}


def seeded_state(cfg_dict, seed: int) -> dict:
    """``seeded_model``'s state_dict for a config dict, built once (the
    card's models of phases 4-4z load it)."""
    from cbim_tpu_torch.config import config_from_dict
    key = _ref_key(cfg_dict, (), seed)
    if key not in SEEDED:
        SEEDED[key] = seeded_model(config_from_dict(cfg_dict),
                                   seed).state_dict()
    return SEEDED[key]


def step_batch(cfg, shape):
    """The train steps' batch of ``shape`` (B, C, *spatial), its labels and
    class weights (seeded)."""
    import torch
    gen = torch.Generator().manual_seed(4)
    img = torch.randn(*shape, generator=gen)
    lab = torch.randint(0, cfg.classes, (shape[0], *shape[2:]), generator=gen)
    return img, lab, [0.5] + [1.0] * (cfg.classes - 1)


def run_step(model, dev, img, lab, weight, amp: bool = False):
    """One train-mode forward and backward of ``model`` on ``dev``: (loss,
    {name: gradient in fp64 on the CPU})."""
    import torch
    from cbim_tpu_torch.ops.losses import deep_supervision_loss
    dtype = next(model.parameters()).dtype
    with torch.autocast("cuda", dtype=torch.bfloat16,
                        enabled=amp and dev.type == "cuda"):
        out = model(img.to(dev, dtype))
        # deep supervision's two heads, or one (the Swin family)
        outs = out if isinstance(out, (list, tuple)) else [out]
        loss = deep_supervision_loss(
            outs, lab.to(dev), [0.5, 0.5] if len(outs) > 1 else [1.0],
            weight)
    loss.backward()
    # a parameter whose output the loss never reads (MedFormer-2D's last
    # semantic-map reductions, DAUNet's heads) gets no grad: zeros, as in JAX
    return float(loss.detach()), {
        k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
        .double() for k, p in model.named_parameters()}


def cpu_eval(cfg_dict, shape):
    """The CPU model's eval softmax (plain versions) on the seeded input of
    ``shape``, seeded weights 1."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    key = _ref_key(cfg_dict, shape)
    if key not in CPU_EVALS:
        model = seeded_model(config_from_dict(cfg_dict), 1)
        SEEDED.setdefault(_ref_key(cfg_dict, (), 1), model.state_dict())
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(2))
        with torch.inference_mode():
            CPU_EVALS[key] = torch.softmax(head0(model(x)), dim=1)
    return CPU_EVALS[key]


def cpu_step(cfg_dict, shape, dtype: str = "float32"):
    """The CPU's train step (plain versions) of seeded weights 3 on
    ``step_batch``, in fp32 or fp64, without remat (the same function, one
    forward fewer); dropout masks fixed (``fixed_dropout_masks``)."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    key = _ref_key(cfg_dict, shape, dtype)
    if key not in CPU_STEPS:
        cfg = config_from_dict(dict(cfg_dict, remat=False))
        model = seeded_model(cfg, 3, train=True).to(getattr(torch, dtype))
        if dtype == "float32":
            # before the step's train-mode forward moves the statistics
            SEEDED.setdefault(_ref_key(cfg_dict, (), 3), {
                k: v.clone() for k, v in model.state_dict().items()})
        with fixed_dropout_masks():
            CPU_STEPS[key] = run_step(model, torch.device("cpu"),
                                      *step_batch(cfg, shape))
    return CPU_STEPS[key]


def convnext_case():
    """Phase 4x's ConvNeXtBlock on the CPU (seeded weights, its layer scale
    drawn from U(0.5, 1.5) so that the MLP counts beside the residual),
    its input and the output's cotangent."""
    import torch
    from cbim_tpu_torch.models import init_weights
    from cbim_tpu_torch.models.layers.convs import ConvNeXtBlock
    gen = torch.Generator().manual_seed(6)
    block = ConvNeXtBlock(CONVNEXT_SHAPE[1], CONVNEXT_SHAPE[1], nd=3)
    init_weights(block, gen)
    with torch.no_grad():
        block.gamma.uniform_(0.5, 1.5, generator=gen)
    x = torch.randn(*CONVNEXT_SHAPE, generator=gen)
    return block, x, torch.randn(*CONVNEXT_SHAPE, generator=gen)


def convnext_step(block, x, g):
    """(output, {name: gradient in fp64 on the CPU}, x's gradient) of
    ``sum(block(x) * g)``."""
    x = x.clone().requires_grad_()
    y = block(x)
    (y * g).sum().backward()
    grads = {k: p.grad.cpu().double() for k, p in block.named_parameters()}
    grads["input"] = x.grad.cpu().double()
    return y.detach().cpu(), grads


def cpu_convnext():
    """``convnext_step`` of ``convnext_case`` on the CPU, computed once."""
    if "convnext" not in CPU_STEPS:
        CPU_STEPS["convnext"] = convnext_step(*convnext_case())
    return CPU_STEPS["convnext"]


def phase_convnext(device) -> tuple[float, float]:
    """Phase 4x's ConvNeXtBlock, card (in channels_last_3d memory, its
    depthwise weight contiguous, as ``get_model`` keeps grouped 3D
    weights) vs CPU: (the output's max error over max|ref|, the gradients'
    relative L2 error, the input's included)."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    block, x, g = convnext_case()
    ref_y, ref_grads = cpu_convnext()
    block = block.to(device, memory_format=torch.channels_last_3d)
    block.dwconv.weight.data = block.dwconv.weight.data.clone(
        memory_format=torch.contiguous_format)
    y, grads = convnext_step(
        block, x.to(device).contiguous(memory_format=torch.channels_last_3d),
        g.to(device))
    err = float((y - ref_y).abs().max() / ref_y.abs().max())
    l2 = math.sqrt(sum(float((grads[k] - r).square().sum())
                       for k, r in ref_grads.items())
                   / sum(float(r.square().sum()) for r in ref_grads.values()))
    assert torch.isfinite(y).all() and err <= MODEL_PROB_ATOL, err
    assert l2 <= STEP_GRAD_L2, l2
    return err, l2


def small_references() -> list:
    """The CPU references phases 4-4z ask for, as (function, args), with
    the configs and shapes those phases pass."""
    zoo2d = dict(SMALL_ZOO_2D)
    refs = [(cpu_eval, (SMALL, (1, 1, 64, 64, 64))),
            (cpu_step, (dict(SMALL, remat=True), (2, 1, 64, 64, 64))),
            (cpu_eval, (SMALL2D, (6, 1, 128, 128))),
            (cpu_step, (SMALL2D, (4, 1, 128, 128)))]
    refs += [(cpu_eval, (SMALL_SWIN, shape)) for shape in SMALL_SWIN_SHAPES]
    refs.append((cpu_step, (SMALL_SWIN, SMALL_SWIN_STEP)))
    for small, shape in ((SMALL_VT, SMALL_VT_SHAPE), (SMALL_NN, SMALL_NN_SHAPE),
                         (SMALL_SU, SMALL_SU_SHAPE)):
        refs += [(cpu_eval, (small, shape)), (cpu_step, (small, shape))]
    for zoo, shape in ((SMALL_ZOO, SMALL_ZOO_SHAPE),
                       (SMALL_ZOO_2D, SMALL_ZOO_2D_SHAPE)):
        for _, small in zoo:
            refs += [(cpu_eval, (small, shape)), (cpu_step, (small, shape))]
    refs.append((cpu_step, (zoo2d["TransUNet"], SMALL_ZOO_2D_SHAPE,
                            "float64")))
    return refs


def option_references() -> list:
    """The CPU references phase 4x asks for, as (function, args)."""
    refs = []
    for _, small, shape in SMALL_OPTIONS:
        refs += [(cpu_eval, (small, shape)), (cpu_step, (small, shape))]
    return refs + [(cpu_convnext, ())]


def write_corpora() -> dict:
    """The NIfTI corpora that phases 6k/6kn (KiTS), 6a (ACDC-3D) and
    9t-9nt (BCV) train on, written under WORK; returns the seconds of
    each."""
    took = {}
    for name, write in (
            ("kits", lambda: kits_config(os.path.join(WORK, "kits_data"))),
            ("acdc3d", lambda: write_corpus(
                os.path.join(WORK, "acdc3d_data"), ACDC3D_CASES,
                ACDC3D_NAMES, seed=2, mr=True, classes=4, frames=2)),
            ("bcv", lambda: write_corpus(os.path.join(WORK, "bcv_data"),
                                         BCV_CASES, BCV_NAMES, seed=3,
                                         classes=14))):
        t0 = time.perf_counter()
        write()
        took[name] = round(time.perf_counter() - t0, 1)
    return took


def prefetch_host_work():
    """Host work that needs no card, in a thread while the card is busy:
    ``small_references`` (on the CPU, most of phases 4-4z) beside phases 3
    and 3a, with one core left to the main thread's launches, then
    ``option_references`` (phase 4x's) beside phases 4-4z, then the serving
    phases' requests (``requests_dir``) and ``write_corpora``.  Returns
    (wait for phases 4-4z's references; wait for phase 4x's, restoring the
    thread count; wait for the rest): each re-raises what failed and
    returns the seconds taken so far, by part."""
    import threading
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 1))
    done = {name: threading.Event() for name in ("references", "options")}
    failed, took = [], {}

    def run():
        for name, refs in (("references", small_references),
                           ("options", option_references)):
            try:
                if not failed:
                    t0 = time.perf_counter()
                    for fn, args in refs():
                        fn(*args)
                    took[name] = round(time.perf_counter() - t0, 1)
            except BaseException as e:        # re-raised by the waiters
                failed.append(e)
            finally:
                done[name].set()
        if not failed:
            try:
                t0 = time.perf_counter()
                for requests, mr in ((REQUESTS, False), (REQUESTS_2D, True)):
                    requests_dir(requests, mr)
                took["requests"] = round(time.perf_counter() - t0, 1)
                took.update(write_corpora())
            except BaseException as e:
                failed.append(e)

    worker = threading.Thread(target=run, name="host-work", daemon=True)
    worker.start()

    def waiter(name, restore=False):
        def wait() -> dict:
            done[name].wait()
            if restore:
                torch.set_num_threads(threads)
            if failed:
                raise failed[0]
            return took
        return wait

    def wait_corpora() -> dict:
        worker.join()
        if failed:
            raise failed[0]
        return took

    return (waiter("references"), waiter("options", restore=True),
            wait_corpora)


def phase_small_model(device, cfg_dict, shape) -> float:
    """Phases 4, 4c and 4d: the small model on ``device`` vs the CPU, same
    weights, on an input of ``shape`` (B, C, *spatial), eval mode."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    cfg = config_from_dict(cfg_dict)
    ref = cpu_eval(cfg_dict, shape)
    dev_model = get_model(cfg, device=device)
    dev_model.load_state_dict(seeded_state(cfg_dict, 1))
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        out = torch.softmax(head0(dev_model(x.to(device))), dim=1).cpu()
    err = float((out - ref).abs().max())
    assert out.shape == (shape[0], cfg.classes, *shape[2:])
    assert torch.isfinite(out).all() and err <= MODEL_PROB_ATOL, err
    return err


def phase_small_train_step(device, cfg_dict, shape, amp: bool = False,
                           f64: bool = False) -> tuple[float, float, float]:
    """Phases 4b and 4c: one train-mode step of the small model on
    ``device`` and on the CPU (``cpu_step``), same weights and batch of
    ``shape`` (B, C, *spatial), fp32 on both or, with ``amp``, under bf16
    autocast on the card.  Returns (loss relative error, the gradient's
    relative L2 error, the worst tensor's error against its tolerance
    scale, which only fp32 asserts).

    ``f64`` (a network whose fp32 gradient is itself ill-conditioned):
    the gradients are held instead against an fp64 step on the CPU, the
    card's fp32 error at most F64_ERR_RATIO times the CPU's fp32 error (or
    STEP_GRAD_L2 and STEP_GRAD_RTOL where those are larger), in relative
    L2 and tensor by tensor; the returned errors are then the card's
    against fp64."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    cfg = config_from_dict(cfg_dict)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev_model = get_model(cfg, device=device, train=True)
    dev_model.load_state_dict(seeded_state(cfg_dict, 3))
    (ref_loss, ref_grads) = cpu_step(cfg_dict, shape)
    loss, grads = run_step(dev_model, device, *step_batch(cfg, shape), amp=amp)

    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    loss_tol = STEP_BF16_LOSS_RTOL if amp else STEP_LOSS_RTOL
    assert math.isfinite(loss) and loss_err <= loss_tol, loss_err

    def errors(got, ref):
        """(relative L2 error, {tensor: max error / its scale})"""
        l2 = math.sqrt(sum(float((got[k] - r).square().sum())
                           for k, r in ref.items())
                       / sum(float(r.square().sum()) for r in ref.values()))
        top = max(float(r.abs().max()) for r in ref.values())
        return l2, {k: float((got[k] - r).abs().max())
                    / (float(r.abs().max()) + STEP_GRAD_FLOOR * top)
                    for k, r in ref.items()}

    l2_tol = STEP_BF16_GRAD_L2 if amp else STEP_GRAD_L2
    tensor_tol = {k: STEP_GRAD_RTOL for k in ref_grads}
    if f64:
        exact = cpu_step(cfg_dict, shape, "float64")[1]
        cpu_l2, cpu_worst = errors(ref_grads, exact)
        l2_tol = max(l2_tol, F64_ERR_RATIO * cpu_l2)
        tensor_tol = {k: max(STEP_GRAD_RTOL, F64_ERR_RATIO * v)
                      for k, v in cpu_worst.items()}
        ref_grads = exact
        say(f"  the CPU's fp32 gradient against fp64: rel L2 {cpu_l2:.3e}, "
            f"worst tensor {max(cpu_worst.values()):.3e} of its scale; the "
            f"card's held to rel L2 {l2_tol:.3e} and each tensor to "
            f"max({STEP_GRAD_RTOL:.0e}, {F64_ERR_RATIO:g}x the CPU's)")
    l2_err, worst = errors(grads, ref_grads)
    assert l2_err <= l2_tol, f"gradient relative L2 error {l2_err:.3e}"
    for k, ref in ref_grads.items():
        # every parameter gets a finite gradient through the card's graph
        assert torch.isfinite(grads[k]).all(), k
        assert float(grads[k].abs().max()) > 0 or float(ref.abs().max()) == 0, k
        assert amp or worst[k] <= tensor_tol[k], \
            f"{k}: {worst[k]:.3e} of its scale (tol {tensor_tol[k]:.3e})"
    return loss_err, l2_err, max(worst.values())


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


def phase_train_validate(device, cfg_dict, batch: int, name: str,
                         on_host_distances=None) -> dict:
    """Phases 6v and 8v: train a recipe with ``val_freq`` 1 through
    ``cbim_tpu_torch.train.main`` with bf16 autocast, so that its epoch
    ends in the EMA model's evaluation on the test split.  The launch
    counters are zeroed just before and read just after; the evaluation's
    model forwards are counted (the eval-mode calls of the model class),
    and per test volume its window sweep (to the label map on the host)
    and host distances are timed and the sweep's peak device memory read.
    ``on_host_distances`` is called as the host distances start, where
    this process leaves the card idle.
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
    argv = ["--dataset", cfg.dataset, "--model", cfg.model, "--dimension",
            cfg.dimension, "--batch_size", str(batch), "--amp",
            "--cp_path", os.path.join(run, "exp"),
            "--log_path", os.path.join(run, "log"), "--unique_name", name,
            "--folds", "1", "--device", str(device)]
    sweep, distances, peaks, forwards = [], [], [], []
    predict, calculate = validation.predict_labels, \
        validation.calculate_distance

    def timed_predict(*args):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        labels = predict(*args)                       # ends on the host
        sweep.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(device))
        return labels

    def timed_calculate(*args):
        if on_host_distances is not None:
            on_host_distances()
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


#: the directories of written requests by (requests, mr)
REQUEST_DIRS: dict = {}


def requests_dir(requests, mr: bool = False) -> str:
    """A directory under WORK holding ``requests`` as NIfTI files
    (``write_requests``, seed 0), written once and read by every serving
    phase that serves them."""
    import zlib
    key = json.dumps([requests, mr])
    if key not in REQUEST_DIRS:
        in_dir = os.path.join(WORK, f"requests_{zlib.crc32(key.encode()):08x}")
        write_requests(in_dir, requests, mr=mr)
        REQUEST_DIRS[key] = in_dir
    return REQUEST_DIRS[key]


#: the config keys that pick kernels or the fusion, not the model's
#: parameters; and the serving phases' seeded weights by the rest of the
#: config: (file, model class, its InstanceNorms)
ROUTE_KEYS = ("conv_na", "conv2d_kernel", "window_fusion")
SERVED_WEIGHTS: dict = {}


def served_weights(cfg_dict, name: str) -> tuple:
    """(file, model class, its InstanceNorms): the serving phases' seeded
    weights (seed 0, on the CPU) of a config, written under WORK/name once
    per model (a route key changes the kernels, not the parameters)."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.models.layers import convs
    key = _ref_key({k: v for k, v in cfg_dict.items()
                    if k not in ROUTE_KEYS}, ())
    if key not in SERVED_WEIGHTS:
        cfg = config_from_dict(cfg_dict)
        weights = os.path.join(WORK, name, f"{cfg.model}_seed0.pth")
        os.makedirs(os.path.dirname(weights), exist_ok=True)
        model = get_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        torch.save(model.state_dict(), weights)
        SERVED_WEIGHTS[key] = (weights, type(model), sum(
            1 for m in model.modules()
            if isinstance(m, convs.Norm) and m.kind == "in"))
        del model
    return SERVED_WEIGHTS[key]


def phase_slice(device, cfg_dict, requests, target_spacing, name: str,
                required, profile_dir: str | None = None) -> dict:
    """Phases 5, 7 and 9: serve ``requests`` with seeded weights through
    prediction; the launch counters and a count of the model's forwards are
    zeroed just before and read just after, and every kernel in
    ``required`` must have launched.  With ``profile_dir``, the requests
    are served once more under the profiler hook, a volume to a step.
    Returns the seconds by request, the launches, the model's forwards,
    the peak memory, the profiled 3^3 forwards by shape and the model's
    InstanceNorms (``norms``)."""
    import numpy as np
    import torch
    from cbim_tpu_torch import prediction
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.data.nifti import read_nifti
    from cbim_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    in_dir = requests_dir(requests, mr=cfg_dict["dimension"] == "2d")
    out_dir = os.path.join(WORK, name, "out")
    cfg = config_from_dict(cfg_dict)
    weights, model_cls, n_norm = served_weights(cfg_dict, name)
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
            "peak_bytes": peak, "conv_shapes": shapes, "norms": n_norm}


def phase_opcheck(device) -> dict:
    """Phase 3's part "ops": ``torch.library.opcheck`` of every ``cbim``
    op on fp32 tensors on ``device`` at one shape (``_library.sample_args``:
    on the card the TF32 routes of C = 8 -> F = 16, the window attention at
    head dim 16 with region ids): the schema, the fake implementation's
    shapes, dtypes and strides against the kernel's output (the plain
    version's on the CPU), and the op under AOT dispatch with dynamic
    shapes.  Returns the seconds by op."""
    import torch
    from cbim_tpu_torch.ops.kernels import _library
    took = {}
    for name, op in _library.OPS.items():
        t0 = time.perf_counter()
        torch.library.opcheck(op, _library.sample_args(name, torch.float32,
                                                        device))
        took[name] = round(time.perf_counter() - t0, 2)
    return took


def _synced(fn):
    """(fn's result, its seconds to the card's end)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serving_window_batch(cfg_dict) -> int:
    """The window batch prediction's ``auto`` takes for phase 5's request
    (its padded shape's unique windows)."""
    from cbim_tpu_torch.inference import engines
    window = tuple(cfg_dict["window_size"])
    return engines._auto_window_batch(len(engines._dedup_starts(
        engines._grid_starts(REQUESTS[0][0], window))[0]))


def start_exports(device, cfg_dict) -> list:
    """Phase 5e's first half, started after the build: the export CLI
    (``python -m cbim_tpu_torch.tools.export_model``, the user's entry
    point) on phase 5's seeded weights (``served_weights``), in two
    processes beside phases 3-5, tracing on the card without launching a
    kernel: the window forward at the serving window batch, and the
    sliding-window program of EXPORT_VOLUME at EXPORT_SW_BATCH.  Returns
    [(name, process, artifact, log, start)]; ``finish_exports`` waits for
    them, and the script's exit stops any still running."""
    import atexit
    import subprocess
    weights = served_weights(cfg_dict, "serve3d")[0]
    out_dir = os.path.join(WORK, "export")
    os.makedirs(out_dir, exist_ok=True)
    base = [sys.executable, "-m", "cbim_tpu_torch.tools.export_model",
            "--dataset", cfg_dict["dataset"], "--model", cfg_dict["model"],
            "--dimension", cfg_dict["dimension"], "--load", weights,
            "--device", str(device)]
    jobs = []
    for name, extra in (
            ("window_forward",
             ["--batch", str(serving_window_batch(cfg_dict))]),
            ("sliding_window",
             ["--volume_shape", ",".join(map(str, EXPORT_VOLUME)),
              "--window_batch", str(EXPORT_SW_BATCH)])):
        art = os.path.join(out_dir, f"{name}.pt2")
        log = os.path.join(out_dir, f"{name}.log")
        with open(log, "w") as f:
            proc = subprocess.Popen([*base, "--out", art, *extra], cwd=ROOT,
                                    stdout=f, stderr=subprocess.STDOUT)
        jobs.append((name, proc, art, log, time.perf_counter()))

    def stop():
        for _, proc, *_ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return jobs


def finish_exports(jobs) -> dict:
    """Waits for :func:`start_exports`'s processes; {name: (artifact,
    the CLI's line, the process's seconds)}; a failed export raises with
    its log."""
    out = {}
    for name, proc, art, log, t0 in jobs:
        rc = proc.wait()
        took = time.perf_counter() - t0
        with open(log) as f:
            text = f.read()
        assert rc == 0, f"export of the {name} failed ({rc}):\n{text[-3000:]}"
        line = [ln for ln in text.splitlines() if ln.startswith("exported")]
        out[name] = (art, line[-1] if line else "", took)
    return out


def export_round_trip(name: str, exported: tuple, live, example) -> dict:
    """One artifact of phase 5e: its bytes loaded; then the loaded program
    and ``live`` (the engine) on ``example``, the launch counters set to 0
    just before each run and read just after: the probabilities within
    EXPORT_ATOL and the launches equal."""
    from cbim_tpu_torch.inference.export import load_exported
    from cbim_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    art, cli_line, export_s = exported
    with open(art, "rb") as f:
        data = f.read()
    fn, load_s = _synced(lambda: load_exported(data))
    _, first_s = _synced(lambda: fn(example))
    reset_launch_counts()
    want, live_s = _synced(lambda: live(example))
    live_counts = launch_counts()
    reset_launch_counts()
    got, loaded_s = _synced(lambda: fn(example))
    counts = launch_counts()
    err = float((got - want).abs().max())
    say(f"  {name}: {cli_line} (its process {export_s:.1f} s to here); "
        f"{len(data)} bytes loaded in {load_s:.2f} s; first call "
        f"{first_s:.3f} s; loaded {loaded_s:.3f} s vs live {live_s:.3f} s; "
        f"probabilities {tuple(got.shape)} max err {err:.3e} (tol "
        f"{EXPORT_ATOL:.0e}); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape)
    assert bool(got.isfinite().all()) and err <= EXPORT_ATOL, err
    assert counts == live_counts and any(counts.values()), \
        (counts, live_counts)
    return counts


def phase_export(device, cfg_dict, jobs) -> collections.Counter:
    """Phase 5e: phase 5's model (its seeded weights, fp32) frozen by the
    export CLI (:func:`start_exports`): the window forward at the serving
    window batch and the sliding-window program of EXPORT_VOLUME (padded
    on z, two window groups), each loaded from its bytes and run beside
    the live engine (:func:`export_round_trip`).  Returns the loaded
    programs' launches."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.inference import engines
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.training.checkpoint import load_weights
    exported = finish_exports(jobs)
    cfg = config_from_dict(cfg_dict)
    model = get_model(cfg, device=device)
    load_weights(served_weights(cfg_dict, "serve3d")[0], model, cfg=cfg)
    window = tuple(cfg.window_size)
    wb = serving_window_batch(cfg_dict)
    gen = torch.Generator().manual_seed(5)
    total = collections.Counter()

    engine = engines.make_engine(model, cfg, wb)

    def live_window(x):
        with torch.inference_mode():
            return engines._softmax_fp32(
                engine.apply_fn(x.movedim(-1, 1))).movedim(1, -1)

    total.update(export_round_trip(
        f"window forward {window} x{wb}", exported["window_forward"],
        live_window, torch.randn((wb, *window, 1), generator=gen).to(device)))

    sweep = engines.make_engine(model, cfg, EXPORT_SW_BATCH)
    n = len(engines._dedup_starts(engines._grid_starts(
        tuple(max(s, w) for s, w in zip(EXPORT_VOLUME, window)), window))[0])
    assert n // EXPORT_SW_BATCH >= 2 and any(
        s < w for s, w in zip(EXPORT_VOLUME, window)), n
    total.update(export_round_trip(
        f"sliding window {EXPORT_VOLUME}, {n} windows by {EXPORT_SW_BATCH}",
        exported["sliding_window"], sweep.sliding_window,
        torch.randn((1, *EXPORT_VOLUME, 1), generator=gen).to(device)))
    del model, engine, sweep
    return total


@contextlib.contextmanager
def assembler_calls():
    """Counts the native batch assembler's calls under it."""
    from cbim_tpu_torch.data import native
    calls = {"n": 0}
    assemble = native.assemble_batch

    def counted(*args, **kw):
        calls["n"] += 1
        return assemble(*args, **kw)

    native.assemble_batch = counted
    try:
        yield calls
    finally:
        native.assemble_batch = assemble


def host_batch_ms(pipe, batch: int) -> dict:
    """ms of DATA_BATCHES host-window copies (``_host_tensors``) each, with
    the native assembler and with the numpy copy."""
    out = {}
    for on in (True, False):
        pipe.native = on
        took = []
        for _ in range(DATA_BATCHES):
            t0 = time.perf_counter()
            pipe._host_tensors(batch)
            took.append(1e3 * (time.perf_counter() - t0))
        out["assembler" if on else "numpy"] = took
    pipe.native = True
    return out


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
    argv = ["--dataset", cfg.dataset, "--model", cfg.model, "--dimension",
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
    serving runs, over the second run's requests (by name; the first run
    served each of them too)."""
    import numpy as np
    from cbim_tpu_torch.data.nifti import read_nifti
    same = total = 0
    for req in sorted(os.listdir(dir_b)):
        a = read_nifti(os.path.join(dir_a, req)).data
        b = read_nifti(os.path.join(dir_b, req)).data
        assert a.shape == b.shape, (req, a.shape, b.shape)
        same += int(np.count_nonzero(a == b))
        total += a.size
    return same / total


@contextlib.contextmanager
def gaussian_sweeps():
    """While inside: the first 3D sliding window of a Gaussian-fusion
    engine is recorded (the engine, its input, its argmax labels); yields
    the list of them.  ``uniform_agreement`` sweeps them again later."""
    from cbim_tpu_torch.inference import engines
    real = engines.InferenceEngine.sliding_window
    seen = []

    def recorded(self, img):
        probs = real(self, img)
        if self.fusion == "gaussian" and not seen:
            seen.append((self, img, probs.argmax(-1)))
        return probs

    engines.InferenceEngine.sliding_window = recorded
    try:
        yield seen
    finally:
        engines.InferenceEngine.sliding_window = real


def uniform_agreement(sweeps) -> float:
    """The share of voxels whose label under a recorded Gaussian sweep is
    the same model's label under uniform fusion (the same windows)."""
    from cbim_tpu_torch.inference import engines
    (engine, img, labels), = sweeps
    uniform = engines.InferenceEngine(
        engine.apply_fn, engine.num_classes, engine.window_size,
        window_batch=engine.window_batch, fusion="uniform")
    same = uniform.sliding_window(img).argmax(-1) == labels
    return float(same.float().mean())


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


@contextlib.contextmanager
def one_rank_group():
    """A one-process NCCL group, started by ``initialize_distributed`` from
    the environment ``torchrun`` gives one rank of one node; the group
    destroyed and the environment restored after."""
    import torch.distributed as dist
    from cbim_tpu_torch.parallel import initialize_distributed
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", GROUP_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert initialize_distributed(device="cuda", group=True)
        assert dist.get_backend() == "nccl"
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def ddp_recorder():
    """While inside: the ``DistributedDataParallel`` wrappers built and
    their forwards."""
    import torch
    seen = {"wrappers": 0, "forwards": 0}
    real = torch.nn.parallel.DistributedDataParallel

    class Counted(real):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen["wrappers"] += 1

        def forward(self, *args, **kw):
            seen["forwards"] += 1
            return super().forward(*args, **kw)

    torch.nn.parallel.DistributedDataParallel = Counted
    try:
        yield seen
    finally:
        torch.nn.parallel.DistributedDataParallel = real


def start_spatial() -> tuple:
    """Phase 6s's ranks (``tools.spatial_train.start``), started before
    phase 5: their processes, imports and contexts come up beside phases
    5-6p, and they wait to be released (``spatial_train.release``: as
    phase 6v's host distances start) to train."""
    from cbim_tpu_torch.tools import spatial_train
    cfg = FLAGSHIP_SPATIAL
    run = os.path.join(WORK, "flagship_spatial")
    return spatial_train.start(
        cfg, spatial_train.train_argv(cfg, TRAIN_BATCH, run,
                                      "flagship_spatial"),
        SPATIAL_RANKS, run, backend="gloo")


def phase_spatial(ranks: tuple, tr: dict) -> collections.Counter:
    """Phase 6s: the ranks of :func:`start_spatial`, released, train
    FLAGSHIP_SPATIAL (``tools.spatial_train.finish``; each rank's counters
    set to 0 just before its ``train.main`` and read just after); its
    losses, sec/step and each rank's peak memory beside phase 6's ``tr``;
    every kernel of SPATIAL_KERNELS launched by every rank every step.
    Returns the launches of both ranks, summed."""
    from cbim_tpu_torch.tools import spatial_train
    cfg = FLAGSHIP_SPATIAL
    records = spatial_train.finish(ranks, timeout=SPATIAL_TIMEOUT)
    res = spatial_train.summary(records, warm=WARMUP_STEPS)
    steps = cfg["iter_per_epoch"]
    say(f"  losses {', '.join(f'{v:.4f}' for v in res['losses'])}; step "
        f"seconds {', '.join(f'{v:.3f}' for v in res['step_seconds'])}")
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(res["losses"], tr["losses"]))
    peaks = ", ".join(f"{g:.2f}" for g in res["peak_gib"])
    walls = ", ".join(f"{r['seconds']:.1f}" for r in records)
    say(f"  losses vs phase 6's: max rel diff {loss_err:.3e} (tol "
        f"{DDP_LOSS_RTOL:.0e}); H-sharded vs phase 6: {res['median_s']:.3f} "
        f"vs {tr['median']:.3f} s/step; peak per rank {peaks} vs "
        f"{tr['peak_bytes'] / 2 ** 30:.2f} GiB; the ranks' train.main "
        f"{walls} s")
    for r in records:
        per_step = {k: r["launches"].get(k, 0) / steps
                    for k in SPATIAL_KERNELS}
        say(f"  rank {r['rank']} launches a step: {per_step}")
        missing = [k for k, v in per_step.items() if v == 0]
        assert not missing, f"rank {r['rank']} never launched {missing}"
    assert len(res["losses"]) == steps and all(
        math.isfinite(v) for v in res["losses"]), res["losses"]
    assert loss_err <= DDP_LOSS_RTOL, (res["losses"], tr["losses"])
    total = collections.Counter()
    for r in records:
        total.update(r["launches"])
    return total


def phase_small_sharded(device) -> dict:
    """Phase 6d's second half, inside the one-process group: phase 4e's
    small model (same seeded weights) on its test volume, the sharded
    sweep at W = 1 against the unsharded one, and ``validate`` with the
    mesh against ``validate`` without."""
    import numpy as np
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.data.datasets import Synthetic3D
    from cbim_tpu_torch.inference.engines import make_engine
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.parallel import make_mesh
    from cbim_tpu_torch.training.validation import validate
    cfg = config_from_dict(SMALL_VAL)
    mesh = make_mesh(cfg)
    assert mesh.size == 1 and mesh.device == device, mesh
    model = get_model(cfg, device=device)
    model.load_state_dict(seeded_model(cfg, 5).state_dict())
    testset = Synthetic3D(cfg, mode="test", k_fold=cfg.k_fold)
    img = testset.test_item(0)[0]
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
        device)[None, ..., None]
    engine = make_engine(model, cfg)
    ref = engine.sliding_window(x)
    out = engine.sliding_window_sharded(x, mesh)
    prob_err = float((out - ref).abs().max())
    one = validate(model, testset, cfg, engine=engine)
    got = validate(model, testset, cfg, engine=engine, mesh=mesh)
    dice_err = float(np.nanmax(np.abs(got[0] - one[0])))
    dist_err = max(float(np.nanmax(np.abs(g - o) / np.maximum(np.abs(o),
                                                             1e-30)))
                   for g, o in zip(got[1:], one[1:]))
    return {"prob_err": prob_err, "dice_err": dice_err,
            "dist_err": dist_err, "dice": got[0]}


@contextlib.contextmanager
def drop_path_recorder():
    """While inside: the stochastic-depth draws of training-mode forwards
    (calls of ``layers.convs.drop_path``, which ``DropPath`` calls) and the
    samples they dropped."""
    from cbim_tpu_torch.models.layers import convs
    seen = {"calls": 0, "dropped": 0}
    real = convs.drop_path

    def counted(x, p, keep):
        seen["calls"] += 1
        # summed on the device: no sync inside the timed steps
        seen["dropped"] = seen["dropped"] + (~keep).sum()
        return real(x, p, keep)

    convs.drop_path = counted
    try:
        yield seen
    finally:
        convs.drop_path = real
        seen["dropped"] = int(seen["dropped"])


@contextlib.contextmanager
def dropout_recorder():
    """While inside: the elementwise dropout draws of training-mode
    forwards (``layers.convs.Dropout.keep_mask``) and the elements they
    dropped, over the elements drawn."""
    from cbim_tpu_torch.models.layers import convs
    seen = {"calls": 0, "dropped": 0, "drawn": 0}
    real = convs.Dropout.keep_mask

    def counted(self, x):
        keep = real(self, x)
        seen["calls"] += 1
        seen["drawn"] += keep.numel()
        # summed on the device: no sync inside the timed steps
        seen["dropped"] = seen["dropped"] + (~keep).sum()
        return keep

    convs.Dropout.keep_mask = counted
    try:
        yield seen
    finally:
        convs.Dropout.keep_mask = real
        seen["dropped"] = int(seen["dropped"])


@contextlib.contextmanager
def fixed_dropout_masks():
    """While inside: VNet's ``ChannelDropout`` keeps whole channels, and
    ``Dropout`` elements, by masks drawn on the CPU from the call's index
    within a forward (VNet's of VNET_DROPOUTS; a Dropout's from the
    context's start, so one forward a context: no remat) and its shape, the
    same on the card and the CPU."""
    import torch
    from cbim_tpu_torch.models import vnet
    from cbim_tpu_torch.models.layers import convs
    calls, drops = [0], [0]
    real, real_drop = vnet.ChannelDropout.keep_mask, convs.Dropout.keep_mask

    def keep_mask(self, x):
        gen = torch.Generator().manual_seed(100 + calls[0] % VNET_DROPOUTS)
        calls[0] += 1
        u = torch.rand(tuple(x.shape[:2]), generator=gen)
        return (u < 1.0 - self.p)[:, :, None, None, None].to(x.device)

    def drop_mask(self, x):
        gen = torch.Generator().manual_seed(200 + drops[0])
        drops[0] += 1
        return (torch.rand(tuple(x.shape), generator=gen)
                < 1.0 - self.p).to(x.device)

    vnet.ChannelDropout.keep_mask = keep_mask
    convs.Dropout.keep_mask = drop_mask
    try:
        yield calls
    finally:
        vnet.ChannelDropout.keep_mask = real
        convs.Dropout.keep_mask = real_drop


def routed_counts(cfg_dict) -> tuple[collections.Counter, int]:
    """The fp32 forward launches of each 3^3 (3D) or 3x3 (2D) kernel per
    forward of the model a config builds (its ConvNormActs on the kernel
    route, by ``conv3d_route``/``conv2d_route``: the TF32 kernel at widths
    of multiples of 8, the CUDA-core one else, as UNet++'s first stage on
    the 1-channel input), and its InstanceNorm modules (on the CPU, no
    forward)."""
    import torch
    from cbim_tpu_torch.config import config_from_dict
    from cbim_tpu_torch.models import get_model
    from cbim_tpu_torch.models.layers import convs
    from cbim_tpu_torch.ops.kernels import conv2d, conv3d
    cfg = config_from_dict(cfg_dict)
    kernels, route = ((conv2d, conv2d.conv2d_route) if cfg.dimension == "2d"
                      else (conv3d, conv3d.conv3d_route))
    model = get_model(cfg, device="cpu")
    fwd = collections.Counter(
        kernels.FORWARD_KEYS[route(
            torch.float32, m.conv.in_channels, m.conv.out_channels)][0]
        for m in model.modules()
        if isinstance(m, convs.ConvNormAct) and m.kernel is not None)
    n_norm = sum(1 for m in model.modules()
                 if isinstance(m, convs.Norm) and m.kind == "in")
    return fwd, n_norm


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
                        help="trace phases 6, 6b, 6p, 6k, 6kn, 6a, 6r, 6x, "
                             "8, 8b, 8f and 8r's steady steps, and the "
                             "requests of phases 5, 5b, 5r, 5p, 9, 9n, 7r "
                             "and 7t served again, into DIR")
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
    # beside nvcc: phase 5's seeded weights, and the opcheck of every op on
    # CPU tensors, which also readies the machinery phase 3's opcheck on the
    # card runs
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        beside = pool.submit(lambda: (served_weights(AMOS, "serve3d"),
                                      phase_opcheck("cpu")))
        _build.library()
        cpu_opcheck = beside.result()[1]
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
    say(f"  beside the build: every cbim op passes torch.library.opcheck on "
        f"CPU tensors (seconds by op: {cpu_opcheck})")
    # phase 5e's exports trace on the card beside phases 3-5 (CPU work in
    # processes of their own, no kernel launched)
    export_jobs = start_exports(device, AMOS)

    record: dict = {}
    wait_references, wait_options, wait_corpora = prefetch_host_work()
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
             (WA_CASES, record)),
            ("ops", phase_opcheck, ())):
        t_part = time.perf_counter()
        fn(device, *fn_args)
        took[part] = round(time.perf_counter() - t_part, 1)
    say(f"  phase 3 took, by part: {took} s; every cbim op passes "
        f"torch.library.opcheck on the card")

    say("[phase 3a] augmentation ops on the card vs the CPU, same draws")
    t_aug = time.perf_counter()
    for name, (err, labels) in phase_aug_ops(device).items():
        say(f"  {name}: max abs err {err:.3e} of max|ref| (tol {AUG_TOL:.0e})"
            f"; labels {'equal' if labels else 'DIFFER'}")
        assert err <= AUG_TOL and labels, (name, err, labels)
    say(f"  phase 3a took {time.perf_counter() - t_aug:.1f} s")

    from cbim_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    launches = {}
    t_wait = time.perf_counter()
    took = wait_references()
    say(f"  the CPU references of phases 4-4z, computed beside phases 3 and "
        f"3a in {took['references']} s, ready after "
        f"{time.perf_counter() - t_wait:.1f} s more")
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
    reset_launch_counts()
    loss_err, l2_err, grad_err = phase_small_train_step(
        device, SMALL_SWIN, SMALL_SWIN_STEP)
    n_attn = launch_counts()["window_attention"]
    say(f"  train step, {SMALL_SWIN_STEP} fp32: loss rel err {loss_err:.3e} "
        f"(tol {STEP_LOSS_RTOL:.0e}); gradient rel L2 err {l2_err:.3e} "
        f"(tol {STEP_GRAD_L2:.0e}); worst tensor err {grad_err:.3e} of its "
        f"scale (tol {STEP_GRAD_RTOL:.0e}); {n_attn} window_attention "
        f"launches (training mode takes the autograd route)")
    assert n_attn == 0, n_attn

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

    say("[phase 4f] small VT-UNet, card vs CPU")
    reset_launch_counts()
    err = phase_small_model(device, SMALL_VT, SMALL_VT_SHAPE)
    n_attn = launch_counts()["window_attention"]
    say(f"  eval, {SMALL_VT_SHAPE} softmax max abs err {err:.3e} (tol "
        f"{MODEL_PROB_ATOL}); {n_attn} window_attention launches (self and "
        f"cross paths)")
    assert n_attn == VT_ATTENTIONS, n_attn
    reset_launch_counts()
    loss_err, l2_err, grad_err = phase_small_train_step(
        device, SMALL_VT, SMALL_VT_SHAPE)
    n_attn = launch_counts()["window_attention"]
    say(f"  train step, drop_path_rate 0, fp32: loss rel err {loss_err:.3e} "
        f"(tol {STEP_LOSS_RTOL:.0e}); gradient rel L2 err {l2_err:.3e} "
        f"(tol {STEP_GRAD_L2:.0e}); worst tensor err {grad_err:.3e} of its "
        f"scale (tol {STEP_GRAD_RTOL:.0e}); {n_attn} window_attention "
        f"launches")
    assert n_attn == 0, n_attn

    for tag, name, small, shape, per_forward in (
            ("4g", "nnFormer", SMALL_NN, SMALL_NN_SHAPE, NN_ATTENTIONS),
            ("4h", "SwinUnet", SMALL_SU, SMALL_SU_SHAPE, SU_ATTENTIONS)):
        say(f"[phase {tag}] small {name}, card vs CPU")
        reset_launch_counts()
        err = phase_small_model(device, small, shape)
        n_attn = launch_counts()["window_attention"]
        say(f"  eval, {shape} softmax max abs err {err:.3e} (tol "
            f"{MODEL_PROB_ATOL}); {n_attn} window_attention launches")
        assert n_attn == per_forward, n_attn
        reset_launch_counts()
        loss_err, l2_err, grad_err = phase_small_train_step(device, small,
                                                            shape)
        n_attn = launch_counts()["window_attention"]
        say(f"  train step, drop_path_rate 0, fp32: loss rel err "
            f"{loss_err:.3e} (tol {STEP_LOSS_RTOL:.0e}); gradient rel L2 err "
            f"{l2_err:.3e} (tol {STEP_GRAD_L2:.0e}); worst tensor err "
            f"{grad_err:.3e} of its scale (tol {STEP_GRAD_RTOL:.0e}); "
            f"{n_attn} window_attention launches")
        assert n_attn == 0, n_attn

    for name, small in SMALL_ZOO:
        say(f"[phase 4u] small {name}, card vs CPU")
        fwd, n_norm = routed_counts(small)
        reset_launch_counts()
        err = phase_small_model(device, small, SMALL_ZOO_SHAPE)
        counts = launch_counts()
        say(f"  eval, {SMALL_ZOO_SHAPE} softmax max abs err {err:.3e} (tol "
            f"{MODEL_PROB_ATOL}); 3^3 launches "
            f"{ {k: counts[k] for k in CONV3D_KERNELS if counts[k]} }, "
            f"{counts['inorm_apply']} inorm_apply")
        # fp32: every routed conv one forward of its route, every
        # InstanceNorm one stats and one apply; VNet's and UNETR's convs
        # and norms are cuDNN's and torch's
        assert all(counts[k] == fwd[k] for k in CONV3D_KERNELS) and \
            counts["inorm_stats"] == counts["inorm_apply"] == n_norm, \
            (counts, fwd, n_norm)
        reset_launch_counts()
        with fixed_dropout_masks():
            loss_err, l2_err, grad_err = phase_small_train_step(
                device, small, SMALL_ZOO_SHAPE)
        counts = launch_counts()
        say(f"  train step, fp32: loss rel err {loss_err:.3e} (tol "
            f"{STEP_LOSS_RTOL:.0e}); gradient rel L2 err {l2_err:.3e} (tol "
            f"{STEP_GRAD_L2:.0e}); worst tensor err {grad_err:.3e} of its "
            f"scale (tol {STEP_GRAD_RTOL:.0e}); 3^3 launches "
            f"{ {k: counts[k] for k in CONV3D_KERNELS if counts[k]} }")
        used = TF32_CONV_KERNELS + ("inorm_bwd_stats", "inorm_bwd_apply")
        assert (all(counts[k] > 0 for k in used) if fwd else
                not any(counts[k] for k in used)), counts
        launches[f"4u {name}"] = counts

    for name, small in SMALL_ZOO_2D:
        say(f"[phase 4z] small {name}, card vs CPU")
        fwd, n_norm = routed_counts(small)
        reset_launch_counts()
        err = phase_small_model(device, small, SMALL_ZOO_2D_SHAPE)
        counts = launch_counts()
        say(f"  eval, {SMALL_ZOO_2D_SHAPE} softmax max abs err {err:.3e} (tol "
            f"{MODEL_PROB_ATOL}); 3x3 launches "
            f"{ {k: counts[k] for k in CONV2D_KERNELS if counts[k]} }, "
            f"{counts['inorm_apply']} inorm_apply")
        # fp32: every routed conv one forward of its route, every
        # InstanceNorm (AttentionUNet's gates) one stats and one apply;
        # TransUNet's convs and norms are cuDNN's and torch's, as XLA's
        assert all(counts[k] == fwd[k] for k in CONV2D_KERNELS) and \
            not any(counts[k] for k in CONV3D_KERNELS) and \
            counts["inorm_stats"] == counts["inorm_apply"] == n_norm, \
            (counts, fwd, n_norm)
        reset_launch_counts()
        # TransUNet's random R50 (weight standardisation before each
        # GroupNorm) has an ill-conditioned fp32 gradient: on the CPU it errs
        # by 2.6e-2 in relative L2 against fp64 at these weights, and one
        # tensor by 0.12 of its scale (PERF.md), above STEP_GRAD_L2;
        # its step is held against an fp64 CPU step (``f64``)
        f64 = small["model"] == "transunet"
        loss_err, l2_err, grad_err = phase_small_train_step(
            device, small, SMALL_ZOO_2D_SHAPE, f64=f64)
        counts = launch_counts()
        tols = (("", "") if f64 else (f" (tol {STEP_GRAD_L2:.0e})",
                                      f" (tol {STEP_GRAD_RTOL:.0e})"))
        say(f"  train step, fp32: loss rel err {loss_err:.3e} (tol "
            f"{STEP_LOSS_RTOL:.0e}); gradient rel L2 err "
            f"{'against fp64 ' if f64 else ''}{l2_err:.3e}{tols[0]}; worst "
            f"tensor err {grad_err:.3e} of its scale{tols[1]}; 3x3 launches "
            f"{ {k: counts[k] for k in CONV2D_KERNELS if counts[k]} }")
        # one step: each TF32 conv its forward, dgrad and wgrad; UNet++'s
        # 1-channel conv the CUDA-core forward and wgrad and no dgrad (its
        # input is the image); each gate norm its forward and backward pairs
        tf32, core = fwd["conv2d_same_fwd_tf32"], fwd["conv2d_same_fwd"]
        want = dict(conv2d_same_fwd_tf32=tf32, conv2d_dgrad_tf32=tf32,
                    conv2d_wgrad_tf32=tf32, conv2d_same_fwd=core,
                    conv2d_wgrad=core, conv2d_dgrad=0, inorm_stats=n_norm,
                    inorm_apply=n_norm, inorm_bwd_stats=n_norm,
                    inorm_bwd_apply=n_norm,
                    **{k: 0 for k in TC2D_KERNELS + CONV3D_KERNELS})
        assert all(counts[k] == v for k, v in want.items()), (counts, want)
        launches[f"4z {name}"] = counts

    t_wait = time.perf_counter()
    took = wait_options()
    say(f"  the CPU references of phase 4x, computed beside phases 4-4z in "
        f"{took['options']} s, ready after "
        f"{time.perf_counter() - t_wait:.1f} s more")
    for name, small, shape in SMALL_OPTIONS:
        say(f"[phase 4x] small {name}, card vs CPU")
        fwd, n_norm = routed_counts(small)
        kernels = CONV2D_KERNELS if small["dimension"] == "2d" \
            else CONV3D_KERNELS
        reset_launch_counts()
        err = phase_small_model(device, small, shape)
        counts = launch_counts()
        say(f"  eval, {shape} softmax max abs err {err:.3e} (tol "
            f"{MODEL_PROB_ATOL}); conv launches "
            f"{ {k: counts[k] for k in kernels if counts[k]} }, "
            f"{counts['inorm_stats']} inorm_stats, {counts['inorm_apply']} "
            f"inorm_apply")
        # fp32: every routed conv one forward of its route, every
        # InstanceNorm one stats and one apply (SiLU: act none, SiLU after)
        assert all(counts[k] == fwd[k] for k in kernels) and \
            counts["inorm_stats"] == counts["inorm_apply"] == n_norm, \
            (counts, fwd, n_norm)
        reset_launch_counts()
        with fixed_dropout_masks():
            loss_err, l2_err, grad_err = phase_small_train_step(
                device, small, shape)
        counts = launch_counts()
        say(f"  train step, fp32: loss rel err {loss_err:.3e} (tol "
            f"{STEP_LOSS_RTOL:.0e}); gradient rel L2 err {l2_err:.3e} (tol "
            f"{STEP_GRAD_L2:.0e}); worst tensor err {grad_err:.3e} of its "
            f"scale (tol {STEP_GRAD_RTOL:.0e}); conv launches "
            f"{ {k: counts[k] for k in kernels if counts[k]} }")
        # each routed conv its forward, dgrad and wgrad on its route; each
        # InstanceNorm its backward pair
        for fk, n in fwd.items():
            route = (TF322D_KERNELS if fk == "conv2d_same_fwd_tf32" else
                     CORE2D_KERNELS if fk == "conv2d_same_fwd" else
                     TF32_CONV_KERNELS if fk == "conv3d_same_fwd_tf32"
                     else CORE_CONV_KERNELS)
            assert all(counts[k] == n for k in route), (counts, fwd)
        assert counts["inorm_bwd_stats"] == counts["inorm_bwd_apply"] == \
            n_norm, (counts, n_norm)
        launches[f"4x {name}"] = counts
    say("[phase 4x] a ConvNeXtBlock alone (7^3 depthwise, 32 channels), card "
        "vs CPU")
    reset_launch_counts()
    err, l2_err = phase_convnext(device)
    say(f"  {CONVNEXT_SHAPE} fp32: output max err {err:.3e} of max|ref| (tol "
        f"{MODEL_PROB_ATOL}); one step's gradients (input included) rel L2 "
        f"err {l2_err:.3e} (tol {STEP_GRAD_L2:.0e}); no kernel launch "
        f"(cuDNN's depthwise conv, torch's LayerNorm and GEMMs)")
    assert not any(launch_counts().values()), launch_counts()

    t_wait = time.perf_counter()
    took = wait_corpora()
    say(f"  the requests and the KiTS, ACDC-3D and BCV cases written beside "
        f"the earlier phases (seconds: {took}), ready after "
        f"{time.perf_counter() - t_wait:.1f} s more")
    from cbim_tpu_torch.tools import spatial_train
    spatial_ranks = start_spatial()
    say("[phase 5] AMOS-CT MedFormer-3D serving 1 NIfTI request")
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

    say("[phase 5e] phase 5's model exported with torch.export: the window "
        "forward and the sliding-window program, loaded and run beside the "
        "live engine")
    launches["5e"] = phase_export(device, AMOS, export_jobs)

    say("[phase 5b] phase 5's request with conv_na: the fused preact conv")
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
    first = sorted(res_na["seconds"])[0]
    say(f"  fused vs unfused (phase 5), {first}: "
        f"{res_na['seconds'][first]:.3f} vs {res['seconds'][first]:.3f} "
        f"sec/volume, peak "
        f"{res_na['peak_bytes'] / 2 ** 30:.2f} vs "
        f"{res['peak_bytes'] / 2 ** 30:.2f} GiB; label maps agree on "
        f"{100 * agree:.4f} % of voxels (min {100 * LABEL_AGREEMENT} %)")
    assert agree >= LABEL_AGREEMENT, agree
    launches["5b"] = counts

    say("[phase 5r] AMOS-CT ResUNet-3D (configs/amos_ct/resunet_3d.yaml) "
        "serving phase 5's request")
    res = phase_slice(device, RESUNET, REQUESTS, TARGET_SPACING,
                      "serve_resunet", FORWARD_KERNELS,
                      profile_dir("serve_resunet"))
    say_serving(res)
    counts, fw = res["launches"], res["forwards"]
    say(f"  per forward: {counts['conv3d_same_fwd_tf32'] / fw:g} "
        f"conv3d_same_fwd_tf32, {counts['inorm_stats'] / fw:g} inorm_stats, "
        f"{counts['inorm_apply'] / fw:g} inorm_apply ({fw} forwards)")
    # fp32 serving: each routed conv one TF32 forward, each norm one stats
    # and one apply, a forward; no other 3^3 kernel
    assert fw > 0 and counts["conv3d_same_fwd_tf32"] == RESUNET_CONVS * fw \
        and counts["inorm_stats"] == counts["inorm_apply"] == \
        RESUNET_NORMS * fw and not any(
            counts[k] for k in CONV3D_KERNELS
            if k != "conv3d_same_fwd_tf32"), f"{counts} in {fw} forwards"
    say_served_profile(args.profile, "serve_resunet", res)
    launches["5r"] = counts

    say("[phase 5p] phase 5's request with proj_type: linear and "
        "window_fusion: gaussian")
    with gaussian_sweeps() as sweeps:
        res = phase_slice(device, LINEAR_GAUSSIAN, REQUESTS, TARGET_SPACING,
                          "serve3d_linear", FORWARD_KERNELS,
                          profile_dir("serve3d_linear"))
    say_serving(res)
    counts, fw = res["launches"], res["forwards"]
    agreement = uniform_agreement(sweeps)
    del sweeps
    # the 1x1 projections and the FusedMBConv feed-forwards take no 3^3
    # kernel: the BasicBlocks' 20 TF32 forwards a forward, as in phase 5;
    # every InstanceNorm one stats and one apply a forward
    n_norm = res["norms"]
    say(f"  per forward: {counts['conv3d_same_fwd_tf32'] / fw:g} "
        f"conv3d_same_fwd_tf32, {counts['inorm_stats'] / fw:g} inorm_stats, "
        f"{counts['inorm_apply'] / fw:g} inorm_apply ({fw} forwards); "
        f"labels equal to the same model's under uniform fusion on "
        f"{100 * agreement:.4f} % of the swept voxels (printed, not held)")
    assert fw > 0 and counts["conv3d_same_fwd_tf32"] == NA_CONVS * fw and \
        counts["inorm_stats"] == counts["inorm_apply"] == n_norm * fw and \
        not any(counts[k] for k in CONV3D_KERNELS
                if k != "conv3d_same_fwd_tf32"), f"{counts} in {fw} forwards"
    say_served_profile(args.profile, "serve3d_linear", res)
    launches["5p"] = counts

    say("[phase 6] flagship MedFormer-3D training, bf16, remat all, "
        f"batch {TRAIN_BATCH}, {FLAGSHIP['iter_per_epoch']} steps")
    tr = phase_train(device, profiled(FLAGSHIP, "flagship"), TRAIN_BATCH,
                     "flagship",
                     ("inorm_stats", "inorm_apply", "inorm_bwd_stats",
                      "inorm_bwd_apply") + TC_CONV_KERNELS,
                     min_steps=FLAGSHIP["iter_per_epoch"])
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
    tr_6 = tr

    say("[phase 6d] the flagship recipe under a one-process NCCL group "
        f"(DDP), {FLAGSHIP_DDP['iter_per_epoch']} steps from phase 6's seed")
    with one_rank_group(), ddp_recorder() as ddp:
        tr_d = phase_train(device, FLAGSHIP_DDP, TRAIN_BATCH, "flagship_ddp",
                           ("inorm_stats", "inorm_apply", "inorm_bwd_stats",
                            "inorm_bwd_apply") + TC_CONV_KERNELS,
                           min_steps=FLAGSHIP_DDP["iter_per_epoch"])
        sharded = phase_small_sharded(device)
    say_train(tr_d, "volumes")
    steps_d = len(tr_d["step_seconds"])
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(tr_d["losses"], tr["losses"]))
    say(f"  {ddp['wrappers']} DDP wrapper, {ddp['forwards']} forwards "
        f"through it; losses vs phase 6's: max rel diff {loss_err:.3e} (tol "
        f"{DDP_LOSS_RTOL:.0e}); DDP vs phase 6: {tr_d['median']:.3f} vs "
        f"{tr['median']:.3f} s/step, peak "
        f"{tr_d['peak_bytes'] / 2 ** 30:.2f} vs "
        f"{tr['peak_bytes'] / 2 ** 30:.2f} GiB")
    assert ddp["wrappers"] == 1 and ddp["forwards"] == steps_d, ddp
    assert steps_d == FLAGSHIP_DDP["iter_per_epoch"] and \
        loss_err <= DDP_LOSS_RTOL, (tr_d["losses"], tr["losses"])
    # the kernels still run under DDP: each step launches what phase 6's
    # step launches
    assert all(v % steps == 0 and tr_d["launches"][k] == v // steps * steps_d
               for k, v in tr["launches"].items()), \
        (tr_d["launches"], tr["launches"])
    say(f"  small model at W = 1: sliding_window_sharded vs sliding_window "
        f"max abs diff {sharded['prob_err']:.2e} (tol {DDP_PROB_ATOL:.0e}); "
        f"validate(mesh) vs validate: Dice {sharded['dice_err']:.2e} (tol "
        f"{DDP_DICE_ATOL:.0e}), distances rel {sharded['dist_err']:.2e} "
        f"(tol {DDP_DISTANCE_RTOL:.0e}); Dice "
        f"{[round(float(v), 4) for v in sharded['dice']]}")
    assert sharded["prob_err"] <= DDP_PROB_ATOL and \
        sharded["dice_err"] <= DDP_DICE_ATOL and \
        sharded["dist_err"] <= DDP_DISTANCE_RTOL, sharded
    launches["6d"] = tr_d["launches"]

    say("[phase 6b] the flagship recipe with conv_na: the fused preact conv")
    tr_na = phase_train(device, profiled(dict(FLAGSHIP, conv_na=True),
                                         "flagship_na"), TRAIN_BATCH,
                        "flagship_na",
                        ("inorm_stats", "inorm_apply", "inorm_bwd_stats",
                         "inorm_bwd_apply", "conv3d_dgrad_tc")
                        + NA_TC_KERNELS, min_steps=FLAGSHIP["iter_per_epoch"])
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

    say("[phase 6p] the flagship recipe with proj_type: linear, attn_drop "
        "0.1 and proj_drop 0.1, bf16, remat all")
    with dropout_recorder() as drops:
        tr_p = phase_train(device, profiled(FLAGSHIP_LINEAR, "flagship_linear"),
                           TRAIN_BATCH, "flagship_linear",
                           ("inorm_stats", "inorm_apply", "inorm_bwd_stats",
                            "inorm_bwd_apply") + TC_CONV_KERNELS,
                           min_steps=FLAGSHIP_LINEAR["iter_per_epoch"])
    say_train(tr_p, "volumes")
    say(f"  {drops['calls']} dropout draws (the forwards and remat's "
        f"recomputes), {100 * drops['dropped'] / max(drops['drawn'], 1):.2f} "
        f"% of {drops['drawn']} elements dropped")
    counts, steps = tr_p["launches"], len(tr_p["step_seconds"])
    # the same 20 BasicBlock convs as phase 6 on the tensor-core route (the
    # 1x1 projections and FusedMBConv feed-forwards take none)
    want = dict(conv3d_same_fwd_tc=2 * NA_CONVS * steps,
                conv3d_dgrad_tc=NA_CONVS * steps,
                conv3d_wgrad_tc=NA_CONVS * steps,
                **{k: 0 for k in CORE_CONV_KERNELS})
    assert drops["calls"] > 0 and steps == FLAGSHIP_LINEAR["iter_per_epoch"] \
        and all(counts[k] == v for k, v in want.items()), (counts, want)
    say(f"  linear with dropout vs depthwise (phase 6): {tr_p['median']:.3f} "
        f"vs {tr['median']:.3f} s/step, peak "
        f"{tr_p['peak_bytes'] / 2 ** 30:.2f} vs "
        f"{tr['peak_bytes'] / 2 ** 30:.2f} GiB")
    if args.profile:
        say_profile(os.path.join(args.profile, "flagship_linear"))
    launches["6p"] = counts

    say("[phase 6v] the flagship recipe validating: 2 steps on five 130^3 "
        "volumes, then the EMA model's 128^3 sliding-window evaluation")
    def release_spatial():
        torch.cuda.empty_cache()      # the ranks' room on the shared card
        spatial_train.release(spatial_ranks)

    # phase 6s's ranks train beside the evaluation's host distances, where
    # this process leaves the card idle
    tv = phase_train_validate(device, FLAGSHIP_VAL, TRAIN_BATCH,
                              "flagship_val",
                              on_host_distances=release_spatial)
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

    say("[phase 6s] the flagship recipe H-sharded over "
        f"{SPATIAL_RANKS} ranks on the one card (mesh_shape "
        f"{FLAGSHIP_SPATIAL['mesh_shape']}, gloo over the card's tensors), "
        f"{FLAGSHIP_SPATIAL['iter_per_epoch']} steps from phase 6's seed, "
        "beside phase 6v's host distances")
    launches["6s"] = phase_spatial(spatial_ranks, tr_6)

    say("[phase 6k] the KiTS recipe as shipped (configs/kits/"
        "medformer_3d.yaml), fp32, batch 2, on written NIfTI cases")
    kits = kits_config(os.path.join(WORK, "kits_data"), write=False,
                       profile_dir=profile_dir("kits"))
    with assembler_calls() as assembled:
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
    # every step's host windows through the native assembler
    assert pipe.native and assembled["n"] >= steps, (pipe.native, assembled)
    data_s = time_batches(pipe, TRAIN_BATCH)
    copy_ms = host_batch_ms(pipe, TRAIN_BATCH)
    say(f"  conv3d_wgrad_tf32 launches {counts['conv3d_wgrad_tf32']}, "
        f"{KITS_CONVS} a step; {assembled['n']} batches assembled "
        f"natively; host-window batches alone "
        f"{', '.join(f'{1e3 * v:.1f}' for v in data_s)} ms; the host copy "
        f"alone, assembler vs numpy: "
        f"{', '.join(f'{v:.1f}' for v in copy_ms['assembler'])} vs "
        f"{', '.join(f'{v:.1f}' for v in copy_ms['numpy'])} ms a batch")
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

    say("[phase 6r] the AMOS-CT ResUNet-3D recipe as shipped, fp32, batch "
        f"{TRAIN_BATCH}, on phase 6's synthetic corpus")
    resunet = load_config("amos_ct", "resunet", "3d",
                          synthetic_cases=FLAGSHIP["synthetic_cases"],
                          synthetic_shape=FLAGSHIP["synthetic_shape"],
                          k_fold=5, epochs=1, iter_per_epoch=RESUNET_STEPS,
                          print_freq=1)
    resunet.dataset = "synthetic"
    if args.profile:
        resunet.profile_dir = profile_dir("resunet")
    tr = phase_train(device, resunet, TRAIN_BATCH, "resunet",
                     ("inorm_stats", "inorm_apply", "inorm_bwd_stats",
                      "inorm_bwd_apply") + TF32_CONV_KERNELS, amp=False,
                     min_steps=RESUNET_STEPS)
    say_train(tr, "volumes")
    counts, steps = tr["launches"], len(tr["step_seconds"])
    # no remat in the UNet family: per step each routed conv one TF32
    # forward, dgrad and wgrad, each norm its stats, apply and backward
    # pair; no tensor-core and no CUDA-core 3^3 launch
    want = dict(conv3d_same_fwd_tf32=RESUNET_CONVS * steps,
                conv3d_dgrad_tf32=RESUNET_CONVS * steps,
                conv3d_wgrad_tf32=RESUNET_CONVS * steps,
                inorm_stats=RESUNET_NORMS * steps,
                inorm_bwd_stats=RESUNET_NORMS * steps,
                inorm_bwd_apply=RESUNET_NORMS * steps,
                **{k: 0 for k in CONV3D_KERNELS
                   if k not in TF32_CONV_KERNELS})
    assert steps == RESUNET_STEPS and all(counts[k] == v
                                          for k, v in want.items()), \
        (counts, want)
    if args.profile:
        say_profile(os.path.join(args.profile, "resunet"))
    launches["6r"] = counts

    say("[phase 6x] the AMOS-CT ResUNet-3D recipe with block: Bottleneck, "
        f"fp32, batch {TRAIN_BATCH}, on phase 6's synthetic corpus")
    fwd, n_norm = routed_counts(RESUNET_BOTTLENECK)
    bottleneck = load_config("amos_ct", "resunet", "3d", block="Bottleneck",
                             synthetic_cases=FLAGSHIP["synthetic_cases"],
                             synthetic_shape=FLAGSHIP["synthetic_shape"],
                             k_fold=5, epochs=1,
                             iter_per_epoch=BOTTLENECK_STEPS, print_freq=1)
    bottleneck.dataset = "synthetic"
    if args.profile:
        bottleneck.profile_dir = profile_dir("resunet_bottleneck")
    tr = phase_train(device, bottleneck, TRAIN_BATCH, "resunet_bottleneck",
                     ("inorm_stats", "inorm_apply", "inorm_bwd_stats",
                      "inorm_bwd_apply") + TF32_CONV_KERNELS, amp=False,
                     min_steps=BOTTLENECK_STEPS)
    say_train(tr, "volumes")
    counts, steps = tr["launches"], len(tr["step_seconds"])
    n_conv = fwd["conv3d_same_fwd_tf32"]
    say(f"  per step: {counts['conv3d_same_fwd_tf32'] / steps:g} "
        f"conv3d_same_fwd_tf32, {counts['conv3d_dgrad_tf32'] / steps:g} "
        f"conv3d_dgrad_tf32, {counts['conv3d_wgrad_tf32'] / steps:g} "
        f"conv3d_wgrad_tf32 ({n_conv} routed convs), "
        f"{counts['inorm_stats'] / steps:g} inorm_stats ({n_norm} norms)")
    # no remat: per step each routed conv one TF32 forward, dgrad and wgrad
    # (mid widths 16-128 and the shortcuts up to 128 wide; 160 and the
    # wide decoder entries on cuDNN), each norm its stats, apply and
    # backward pair; no tensor-core and no CUDA-core 3^3 launch
    want = dict(conv3d_same_fwd_tf32=n_conv * steps,
                conv3d_dgrad_tf32=n_conv * steps,
                conv3d_wgrad_tf32=n_conv * steps,
                inorm_stats=n_norm * steps, inorm_bwd_stats=n_norm * steps,
                inorm_bwd_apply=n_norm * steps,
                **{k: 0 for k in CONV3D_KERNELS
                   if k not in TF32_CONV_KERNELS})
    assert n_conv > 0 and fwd == {"conv3d_same_fwd_tf32": n_conv} and \
        steps == BOTTLENECK_STEPS and all(counts[k] == v
                                          for k, v in want.items()), \
        (counts, want)
    if args.profile:
        say_profile(os.path.join(args.profile, "resunet_bottleneck"))
    launches["6x"] = counts

    say("[phase 7] ACDC MedFormer-2D serving 1 NIfTI request (slice batch)")
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

    say("[phase 7b] the same request with conv2d_kernel off (cuDNN fp32)")
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

    say("[phase 7s] ACDC SwinUnet-2D (configs/acdc/swinunet_2d.yaml) serving "
        "1 NIfTI request (slice batch)")
    res = phase_slice(device, ACDC_SU, REQUESTS_2D, TARGET_SPACING_2D,
                      "serve_su", ("window_attention",))
    say_serving(res)
    n_attn = res["launches"]["window_attention"]
    assert res["forwards"] > 0 and \
        n_attn == SU_ATTENTIONS * res["forwards"], \
        f"{n_attn} window-attention launches in {res['forwards']} forwards"
    launches["7s"] = res["launches"]

    say("[phase 8s] the ACDC SwinUnet-2D recipe as shipped, fp32, batch "
        f"{TRAIN2D_BATCH}, stochastic depth 0.1, one epoch of Synthetic2D")
    acdc_su = load_config("acdc", "swinunet", "2d",
                          synthetic_cases=SU_TRAIN_CASES, k_fold=5, epochs=1,
                          print_freq=1)
    acdc_su.dataset = "synthetic"
    with drop_path_recorder() as drops:
        tr = phase_train(device, acdc_su, TRAIN2D_BATCH, "acdc_su", (),
                         amp=False, min_steps=SU_STEPS)
    say_train(tr, "slices")
    say(f"  {drops['calls']} DropPath draws, {drops['dropped']} samples "
        f"dropped")
    assert drops["calls"] > 0 and len(tr["step_seconds"]) == SU_STEPS and \
        tr["launches"]["window_attention"] == 0, (drops, tr["launches"])
    launches["8s"] = tr["launches"]

    say("[phase 7r] ACDC ResUNet-2D (configs/acdc/resunet_2d.yaml) serving "
        "phase 7's first request (slice batch)")
    res = phase_slice(device, ACDC_RESUNET, REQUESTS_2D, TARGET_SPACING_2D,
                      "serve_resunet2d", ("conv2d_same_fwd_tf32",),
                      profile_dir("serve_resunet2d"))
    say_serving(res)
    if args.profile:
        say_profile(os.path.join(args.profile, "serve_resunet2d"), "volume")
    counts, fw = res["launches"], res["forwards"]
    say(f"  per forward: {counts['conv2d_same_fwd_tf32'] / fw:g} "
        f"conv2d_same_fwd_tf32 ({fw} forwards)")
    # fp32 serving: each routed conv one TF32 forward a forward, no other
    # 3x3 kernel
    assert fw > 0 and counts["conv2d_same_fwd_tf32"] == \
        ACDC_RESUNET_CONVS * fw and not any(
            counts[k] for k in CONV2D_KERNELS
            if k != "conv2d_same_fwd_tf32"), f"{counts} in {fw} forwards"
    launches["7r"] = counts

    say("[phase 8r] the ACDC ResUNet-2D recipe as shipped, fp32, batch "
        f"{TRAIN2D_BATCH}, on the TF32 3x3 kernels, one epoch of Synthetic2D")
    resunet2d = load_config("acdc", "resunet", "2d",
                            synthetic_cases=SU_TRAIN_CASES, k_fold=5,
                            epochs=1, print_freq=1, conv2d_kernel=True)
    resunet2d.dataset = "synthetic"
    if args.profile:
        resunet2d.profile_dir = profile_dir("resunet2d")
    tr = phase_train(device, resunet2d, TRAIN2D_BATCH, "resunet2d",
                     TF322D_KERNELS, amp=False, min_steps=SU_STEPS)
    say_train(tr, "slices")
    if args.profile:
        say_profile(os.path.join(args.profile, "resunet2d"))
    counts, steps = tr["launches"], len(tr["step_seconds"])
    # per step each routed conv one TF32 forward, dgrad and wgrad; no
    # tensor-core and no CUDA-core 3x3 launch
    want = dict({k: ACDC_RESUNET_CONVS * steps for k in TF322D_KERNELS},
                **{k: 0 for k in TC2D_KERNELS + CORE2D_KERNELS})
    assert steps == SU_STEPS and all(counts[k] == v
                                     for k, v in want.items()), \
        (counts, want)
    assert all(math.isfinite(v) for v in tr["losses"]), tr["losses"]
    launches["8r"] = counts

    say("[phase 7t] ACDC TransUNet (configs/acdc/transunet_2d.yaml: "
        "R50-ViT-B/16) serving phase 7's first request (slice batch)")
    res = phase_slice(device, ACDC_TRANSUNET, REQUESTS_2D,
                      TARGET_SPACING_2D, "serve_transunet", (),
                      profile_dir("serve_transunet"))
    say_serving(res)
    if args.profile:
        say_profile(os.path.join(args.profile, "serve_transunet"), "volume")
    counts = res["launches"]
    # cuDNN's convs, torch's norms and GEMMs, as XLA's in JAX: no kernel
    assert res["forwards"] > 0 and not any(counts.values()), counts
    launches["7t"] = counts

    say("[phase 9] BCV SwinUNETR serving 1 NIfTI request")
    res = phase_slice(device, BCV, REQUESTS, TARGET_SPACING,
                      "serve_swin", ("window_attention",),
                      profile_dir("swin"))
    say_serving(res)
    if args.profile is not None:
        say_profile(profile_dir("swin"), "volume")
    n_attn = res["launches"]["window_attention"]
    assert res["forwards"] > 0 and n_attn == SWIN_BLOCKS * res["forwards"], \
        f"{n_attn} window-attention launches in {res['forwards']} forwards"
    launches["9"] = res["launches"]

    say("[phase 9t] the BCV SwinUNETR recipe as shipped (configs/bcv/"
        f"swin_unetr_3d.yaml), fp32, batch {TRAIN_BATCH}, on written NIfTI "
        "cases")
    bcv_root = os.path.join(WORK, "bcv_data")
    bcv_keys = dict(data_root=bcv_root, epochs=1, iter_per_epoch=BCV_STEPS,
                    print_freq=1)
    tr = phase_train(device, load_config("bcv", "swin_unetr", "3d", **bcv_keys),
                     TRAIN_BATCH, "bcv_swin", (), amp=False,
                     min_steps=BCV_STEPS)
    say_train(tr, "volumes")
    # the training route: no window-attention launch in a step
    assert len(tr["step_seconds"]) == BCV_STEPS and \
        tr["launches"]["window_attention"] == 0, tr["launches"]
    launches["9t"] = tr["launches"]

    say("[phase 9u] BCV VT-UNet (configs/bcv/vtunet_3d.yaml) serving 1 "
        "NIfTI request")
    res = phase_slice(device, BCV_VT, REQUESTS, TARGET_SPACING,
                      "serve_vt", ("window_attention",))
    say_serving(res)
    n_attn = res["launches"]["window_attention"]
    assert res["forwards"] > 0 and \
        n_attn == VT_ATTENTIONS * res["forwards"], \
        f"{n_attn} window-attention launches in {res['forwards']} forwards"
    launches["9u"] = res["launches"]

    say("[phase 9ut] the BCV VT-UNet recipe as shipped, fp32, batch "
        f"{TRAIN_BATCH}, stochastic depth 0.1, on phase 9t's cases")
    with drop_path_recorder() as drops:
        tr = phase_train(device, load_config("bcv", "vtunet", "3d",
                                             **bcv_keys),
                         TRAIN_BATCH, "bcv_vt", (), amp=False,
                         min_steps=BCV_STEPS)
    say_train(tr, "volumes")
    say(f"  {drops['calls']} DropPath draws, {drops['dropped']} samples "
        f"dropped")
    assert drops["calls"] > 0 and \
        len(tr["step_seconds"]) == BCV_STEPS and \
        tr["launches"]["window_attention"] == 0, (drops, tr["launches"])
    launches["9ut"] = tr["launches"]

    say("[phase 9n] BCV nnFormer (configs/bcv/nnformer_3d.yaml) serving 1 "
        "NIfTI request")
    res = phase_slice(device, BCV_NN, REQUESTS, TARGET_SPACING,
                      "serve_nn", ("window_attention",),
                      profile_dir("nnformer"))
    say_serving(res)
    if args.profile is not None:
        say_profile(profile_dir("nnformer"), "volume")
    n_attn = res["launches"]["window_attention"]
    assert res["forwards"] > 0 and \
        n_attn == NN_ATTENTIONS * res["forwards"], \
        f"{n_attn} window-attention launches in {res['forwards']} forwards"
    launches["9n"] = res["launches"]

    say("[phase 9nt] the BCV nnFormer recipe as shipped, fp32, batch "
        f"{TRAIN_BATCH}, stochastic depth 0.2, on phase 9t's cases")
    with drop_path_recorder() as drops:
        tr = phase_train(device, load_config("bcv", "nnformer", "3d",
                                             **bcv_keys),
                         TRAIN_BATCH, "bcv_nn", (), amp=False,
                         min_steps=BCV_STEPS)
    say_train(tr, "volumes")
    say(f"  {drops['calls']} DropPath draws, {drops['dropped']} samples "
        f"dropped")
    assert drops["calls"] > 0 and \
        len(tr["step_seconds"]) == BCV_STEPS and \
        tr["launches"]["window_attention"] == 0, (drops, tr["launches"])
    launches["9nt"] = tr["launches"]

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
