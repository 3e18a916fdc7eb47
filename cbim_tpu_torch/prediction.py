"""Prediction / deployment CLI of the port (counterpart of the root
``prediction.py``).

Per image: read NIfTI -> resample to the target spacing (cubic spline;
in 2D the slice spacing stays and only y/x are resampled) -> dataset
normalization -> pad to the training size (2D: y/x only) -> for each
checkpoint a sliding-window softmax (2D: every slice of the volume is the
batch at each window position), summed on the device -> argmax -> unpad ->
nearest-resample back to the original grid -> write NIfTI.

Usage:
    python -m cbim_tpu_torch.prediction --dataset amos_ct --model medformer \\
        --dimension 3d --load w1.pth,w2.pth --img_path in_dir \\
        --save_path out_dir --target_spacing 1.5,1.5,1.5 [--device cuda]
    python -m cbim_tpu_torch.prediction --dataset acdc --model medformer \\
        --dimension 2d --load w.pth --img_path in_dir --save_path out_dir \\
        --target_spacing 1.5625,1.5625

``--load`` takes the port trainer's ``.ckpt`` (its EMA weights when the
config sets ``ema``, else its ``model``), the JAX package's Flax msgpack
``.ckpt`` (``ema_params`` and ``ema_batch_stats`` when the config sets
``ema`` and the run kept them, else ``params`` and ``batch_stats``: the
trained BatchNorm statistics, where the JAX CLI serves initial ones), the
reference trainer's {model_state_dict, ema_model_state_dict} wrapper (EMA
first) and bare ``.pth`` state_dicts, through
``training.checkpoint.load_weights``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_spacing_list(string):
    return tuple(float(s) for s in string.split(","))


def parse_model_list(string):
    return string.split(",")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="CBIM-Torch prediction")
    parser.add_argument("--dataset", type=str, default="kits")
    parser.add_argument("--model", type=str, default="unet")
    parser.add_argument("--dimension", type=str, default="3d")
    parser.add_argument("--load", type=parse_model_list, default=False,
                        help="comma-separated .ckpt/.pth weights for "
                             "ensembling")
    parser.add_argument("--img_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, default="./result/")
    parser.add_argument("--target_spacing", type=parse_spacing_list,
                        default="1.0,1.0,1.0",
                        help="training spacing, x,y,z order (2d: x,y)")
    parser.add_argument("--normalize", type=str, default=None,
                        help="normalization preset (defaults to --dataset)")
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--window_batch", default="auto",
                        help="windows per forward: an int, or 'auto' = the "
                             "largest wb <= 6 dividing the window count")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (an sm_90 card; an error without one) "
                             "or 'cpu'")
    return parser


NORMALIZERS = {
    # the training constants of cbim_tpu/data/datasets.py
    "acdc": lambda x: _percentile_norm(x),
    "lits": lambda x: (np.clip(x, -17, 201) - 99.40) / 39.39,
    "kits": lambda x: (np.clip(x, -79, 304) - 100.93) / 76.90,
    "bcv": lambda x: (np.clip(x, -958, 327) - 82.92) / 136.97,
    "amos_ct": lambda x: (np.clip(x, -991, 362) - 50.0) / 141.0,
    "amos_mr": lambda x: _mr_norm(x),
    "synthetic": lambda x: x,
}


def _percentile_norm(x):
    m = np.percentile(x, 98)
    return np.clip(x, 0, m) / m


def _mr_norm(x):
    p2, p98 = np.percentile(x, 2), np.percentile(x, 98)
    x = np.clip(x, p2, p98)
    return (x - x.mean()) / x.std()


def pad_to_training_size(np_img, cfg):
    """reference prediction.py:65-122 (records unpad indices); 2D pads y/x
    only."""
    ts = cfg.training_size
    axes = [0, 1, 2] if cfg.dimension == "3d" else [1, 2]
    idx = []
    pads = [(0, 0)] * 3
    for i, ax in enumerate(axes):
        size = np_img.shape[ax]
        if size < ts[i]:
            diff = (ts[i] + 2 - size) // 2
            pads[ax] = (diff, diff)
            idx += [diff, diff + size]
        else:
            idx += [0, size]
    if any(p != (0, 0) for p in pads):
        np_img = np.pad(np_img, pads)
    return np_img, idx


def unpad(np_pred, idx, cfg):
    if cfg.dimension == "3d":
        z0, z1, y0, y1, x0, x1 = idx
        return np_pred[z0:z1, y0:y1, x0:x1]
    y0, y1, x0, x1 = idx
    return np_pred[:, y0:y1, x0:x1]


def main(argv=None, cfg=None) -> dict:
    """Run the CLI on ``argv`` (default: sys.argv).  ``cfg`` replaces the
    YAML lookup with an already-built config.  Returns {image name: seconds
    from reading it to writing its prediction}."""
    args = get_parser().parse_args(argv)

    from .config import load_config
    from .data.conversion import resample_label_to_shape, resample_to_spacing
    from .data.nifti import read_nifti, write_nifti
    from .inference.engines import make_engine
    from .models import get_model
    from .ops._backend import get_device
    from .training.checkpoint import load_weights

    device = get_device(args.device)
    if args.dimension not in ("2d", "3d"):
        raise ValueError(f"--dimension must be 2d or 3d, got {args.dimension!r}")
    if cfg is None:
        cfg = load_config(args.dataset, args.model, args.dimension,
                          config_root=args.config_root)
    # force sliding window at training size (reference prediction.py:269-270)
    cfg.sliding_window = True
    cfg.window_size = cfg.training_size

    normalize = NORMALIZERS[args.normalize or args.dataset]

    engines = []
    for ckpt in (args.load or []):
        model = get_model(cfg, device=device)
        load_weights(ckpt, model, prefer_ema=bool(cfg.get("ema", False)),
                     cfg=cfg)
        engines.append(make_engine(model, cfg, window_batch=args.window_batch))
        print(f"Model loaded from {ckpt}")

    os.makedirs(args.save_path, exist_ok=True)
    target_spacing_zyx = tuple(reversed(args.target_spacing))

    seconds = {}
    for img_name in sorted(os.listdir(args.img_path)):
        if not (img_name.endswith(".nii") or img_name.endswith(".nii.gz")):
            continue
        t0 = time.perf_counter()
        nii = read_nifti(os.path.join(args.img_path, img_name))
        orig_shape = nii.data.shape
        data = nii.data.astype(np.float32)
        tspc = (target_spacing_zyx if cfg.dimension == "3d"
                else (nii.spacing[0], *target_spacing_zyx[-2:]))
        if tuple(np.round(nii.spacing, 5)) != tuple(np.round(tspc, 5)):
            data = resample_to_spacing(data, nii.spacing, tspc, order=3)
        data = normalize(data)
        data, idx = pad_to_training_size(data, cfg)

        inputs = torch.from_numpy(np.ascontiguousarray(data, np.float32))
        inputs = inputs.to(device)[..., None]
        prob_sum = None
        for e in engines:
            if cfg.dimension == "2d":        # the slices are the batch
                probs = e.sliding_window_slices(inputs)
            else:
                probs = e.sliding_window(inputs[None])[0]
            prob_sum = probs if prob_sum is None else prob_sum + probs
        pred = prob_sum.argmax(-1).to(torch.uint8).cpu().numpy()

        pred = unpad(pred, idx, cfg)
        if pred.shape != orig_shape:
            pred = resample_label_to_shape(pred, orig_shape)
        write_nifti(os.path.join(args.save_path, img_name),
                    pred.astype(np.uint8), spacing=nii.spacing,
                    affine=nii.affine)
        seconds[img_name] = time.perf_counter() - t0
        print(f"{img_name} done in {seconds[img_name]:.3f} s")
    return seconds


if __name__ == "__main__":
    main()
