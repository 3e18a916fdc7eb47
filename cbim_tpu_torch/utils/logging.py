"""Logging, meters and metric writing (counterpart of
``cbim_tpu/utils/logging.py``; reference utils.py:10-99).  One process, so
no rank gating; scalars go to a JSON-lines file."""

from __future__ import annotations

import json
import logging
import os
import sys
import time


def configure_logger(log_file: str | None = None) -> None:
    """INFO to stdout and, when given, appended to ``log_file``."""
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file, mode="a"))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        handlers=handlers, force=True)


class AverageMeter:
    """reference utils.py:59-78."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """reference utils.py:81-99."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        num_digits = len(str(num_batches // 1))
        self.batch_fmtstr = "[{:" + str(num_digits) + "d}/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        logging.info("  ".join(entries))


class MetricWriter:
    """Scalar sink: one JSON line per scalar in ``log_dir/scalars.jsonl``,
    {"tag", "value", "step", "t"}, the JAX package's format."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "t": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def log_evaluation_result(writer: MetricWriter, dice, asd, hd, name: str,
                          epoch: int) -> None:
    """The per-class and mean Dice, ASD and HD scalars of one evaluation,
    at step epoch + 1 (reference training/utils.py:17-28)."""
    for kind, values in (("Dice", dice), ("ASD", asd), ("HD", hd)):
        writer.add_scalar(f"{kind}/{name}_AVG", values.mean(), epoch + 1)
        for i, v in enumerate(values):
            writer.add_scalar(f"{kind}/{name}_{kind}{i + 1}", v, epoch + 1)
