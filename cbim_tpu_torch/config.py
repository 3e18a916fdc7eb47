"""Config system (counterpart of ``cbim_tpu/config.py``): argparse-style
defaults merged with a per-experiment YAML into one flat namespace.

Same precedence and the same ``amp -> compute_dtype = 'bfloat16'`` rule as
``cbim_tpu``.  PyYAML is imported inside :func:`load_config` only, so a
config built with :func:`config_from_dict` needs no YAML parser.
"""

from __future__ import annotations

import os
from typing import Any

import torch


class Config:
    """A flat attribute namespace, like the reference's merged ``args``."""

    def __init__(self, **kwargs: Any):
        for k, v in kwargs.items():
            setattr(self, k, v)

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)


#: defaults for the CLI tier (reference train.py:240-257)
CLI_DEFAULTS = dict(
    dataset="acdc",
    model="unet",
    dimension="2d",
    pretrain=False,
    amp=False,                 # selects bf16 compute
    batch_size=32,
    resume=False,
    load=False,
    cp_path="./exp/",
    log_path="./log/",
    unique_name="test",
)

#: defaults for keys that some reference YAMLs omit (``cbim_tpu``'s, less
#: its TPU mesh block)
YAML_DEFAULTS = dict(
    in_chan=1,
    base_chan=32,
    norm="bn",
    act="relu",
    aux_loss=False,
    aux_weight=[1.0],
    ema=False,
    ema_alpha=0.99,
    val_freq=10,
    sliding_window=False,
    window_size=None,
    iter_per_epoch=200,
    print_freq=10,
    start_epoch=0,
    split_seed=0,
    k_fold=5,
    rlt=1,
    momentum=0.9,
    weight_decay=0.0,
    betas=[0.9, 0.999],
    reproduce_seed=None,
    affine_pad_size=[0, 0, 0],
    scale=0.0,
    rotate=0,
    translate=0.0,
    gaussian_noise_std=0.0,
    additive_brightness_std=0.0,
    gamma_range=[1.0, 1.0],
    compute_dtype="float32",   # 'bfloat16' when amp is requested
    conv_na=False,             # MedFormer-3D's fused preact conv (CBIM_CONV_NA)
)


def find_config_path(dataset: str, model: str, dimension: str,
                     config_root: str | None = None) -> str:
    """``configs/<dataset>/<model>_<dimension>.yaml`` (reference train.py:260)."""
    roots = []
    if config_root:
        roots.append(config_root)
    roots.append(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs"))
    for root in roots:
        path = os.path.join(root, dataset, f"{model}_{dimension}.yaml")
        if os.path.exists(path):
            return path
    raise ValueError(
        f"The specified configuration doesn't exist: "
        f"{dataset}/{model}_{dimension}.yaml (searched {roots})")


def _finish(merged: dict) -> Config:
    cfg = Config(**merged)
    if getattr(cfg, "amp", False):
        cfg.compute_dtype = "bfloat16"
    return cfg


def load_config(dataset: str = "acdc", model: str = "unet",
                dimension: str = "2d", config_root: str | None = None,
                **overrides: Any) -> Config:
    """Precedence (lowest to highest): YAML_DEFAULTS < CLI_DEFAULTS < the
    YAML file of (dataset, model, dimension) < ``overrides``."""
    import yaml

    path = find_config_path(dataset, model, dimension, config_root)
    with open(path, "r") as f:
        yaml_cfg = yaml.safe_load(f) or {}
    return config_from_dict({"dataset": dataset, "model": model,
                             "dimension": dimension, **yaml_cfg}, **overrides)


def config_from_dict(d: dict, **overrides: Any) -> Config:
    """Defaults merged under ``d`` and ``overrides`` over it, the way
    :func:`load_config` merges a YAML file."""
    return _finish({**YAML_DEFAULTS, **CLI_DEFAULTS, **d, **overrides})


def save_configure(cfg: Config, out_dir: str) -> None:
    """Snapshot the merged config to ``config.txt`` (reference
    utils.py:30-39)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.txt"), "w") as f:
        for name, value in sorted(cfg.__dict__.items()):
            f.write(f"{name}: {value}\n")


def compute_dtype(cfg) -> torch.dtype:
    return (torch.bfloat16 if cfg.get("compute_dtype", "float32") == "bfloat16"
            else torch.float32)


def set_float32_precision(cfg) -> None:
    """fp32 compute runs in full fp32, as ``cbim_tpu`` does on the CPU:
    cuDNN's default TF32 convolutions (and TF32 matmuls) would keep only
    about three decimal digits."""
    if compute_dtype(cfg) == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
