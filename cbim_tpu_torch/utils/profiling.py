"""The trainer's profiler hook (counterpart of the JAX trainer's
``profile_dir`` trace), on ``torch.profiler``; ``chip_smoke.py --profile``
also traces a serving run with it, a volume to a step.

One window of train steps is traced; on stop, ``profile_dir`` gets
``kernels.txt`` (``key_averages`` sorted by device time) and
``summary.json``: the window's wall seconds (between two device
synchronisations), the device kernels' summed seconds, their share of the
wall time (the device's busy share; one stream, so kernels do not overlap),
the device time of every kernel by name, and per step by family
(:data:`FAMILIES`).  On the CPU only host activity is traced and the
device lists are empty.
"""

from __future__ import annotations

import json
import os
import time

import torch


#: kernel families, the first whose pattern is in a kernel's name; the rest
#: count as "other elementwise"
FAMILIES = [
    ("window attention kernel", "window_attention_kernel"),
    ("conv fwd/dgrad kernels", "same_fwd_kernel"),
    ("conv wgrad kernels", "_wgrad_"),
    ("InstanceNorm kernels", "inorm_"),
    ("BatchNorm", "batch_norm"),
    ("depthwise 3D convs", "depthwise"),
    ("cuDNN convs", "conv"),
    ("cuDNN convs", "grad2d"),
    ("cuDNN convs", "fprop"),
    ("cuDNN convs", "dgrad"),
    ("upsample", "upsample"),
    ("softmax", "SoftMax"),
    ("layout copies and casts", "copy"),
    ("GEMMs", "gemm"),
    ("GEMMs", "cutlass"),
    ("GEMMs", "nvjet"),
    ("reductions", "reduce_kernel"),
    ("grid_sample", "grid_sampler"),
]


def family(kernel_name: str) -> str:
    for label, pattern in FAMILIES:
        if pattern in kernel_name:
            return label
    return "other elementwise"


class StepProfiler:
    def __init__(self, profile_dir: str, device: torch.device):
        self.dir = profile_dir
        self.device = device
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._t0 = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, steps: int) -> dict:
        """End the window of ``steps`` train steps and write its files;
        returns the summary."""
        self._sync()
        wall = time.perf_counter() - self._t0
        self._prof.stop()
        events = self._prof.key_averages()
        kernels = sorted(
            ((e.key, e.self_device_time_total / 1e3, e.count) for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda k: -k[1])
        device_s = sum(ms for _, ms, _ in kernels) / 1e3
        families: dict[str, float] = {}
        for name, ms, _ in kernels:
            families[family(name)] = families.get(family(name), 0.0) + ms / steps
        summary = {"steps": steps, "wall_seconds": wall,
                   "device_kernel_seconds": device_s,
                   "device_busy_share": device_s / wall if wall else 0.0,
                   "families_ms_per_step": dict(sorted(
                       families.items(), key=lambda kv: -kv[1])),
                   "kernels_ms": [[k, ms, n] for k, ms, n in kernels]}
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, "kernels.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total"
                                 if kernels else "self_cpu_time_total",
                                 row_limit=60))
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return summary
