"""The port runs without JAX: every module imports with ``jax``, ``flax``
and ``msgpack`` blocked, and it loads no module of the JAX package
``cbim_tpu``, not even one that imports nothing of JAX: the port keeps its
own copies.

Each module is imported in a process of its own, forked from one that has
blocked the three and imported only numpy and torch (which every module of
the port imports first), so that a probe costs the module's own imports
and not an interpreter's start and torch's import each time."""

import json
import os
import select
import subprocess
import sys

import pytest
from test_torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "cbim_tpu_torch",
    "cbim_tpu_torch.config",
    "cbim_tpu_torch.ops._backend",
    "cbim_tpu_torch.ops.activations",
    "cbim_tpu_torch.ops.interpolate",
    "cbim_tpu_torch.ops.losses",
    "cbim_tpu_torch.ops.augment",
    "cbim_tpu_torch.ops.resample",
    "cbim_tpu_torch.ops._surfel_tables",
    "cbim_tpu_torch.ops.metrics",
    "cbim_tpu_torch.ops.kernels",
    "cbim_tpu_torch.ops.kernels._build",
    "cbim_tpu_torch.ops.kernels._library",
    "cbim_tpu_torch.ops.kernels.conv2d",
    "cbim_tpu_torch.ops.kernels.conv3d",
    "cbim_tpu_torch.ops.kernels.fused_norm",
    "cbim_tpu_torch.ops.kernels.probes",
    "cbim_tpu_torch.ops.kernels.window_attention",
    "cbim_tpu_torch.models",
    "cbim_tpu_torch.models.layers.convs",
    "cbim_tpu_torch.models.layers.transformers",
    "cbim_tpu_torch.models.medformer",
    "cbim_tpu_torch.models.swin_layers",
    "cbim_tpu_torch.models.unetr",
    "cbim_tpu_torch.models.swin_unetr",
    "cbim_tpu_torch.models.vtunet",
    "cbim_tpu_torch.models.nnformer",
    "cbim_tpu_torch.models.swin_unet",
    "cbim_tpu_torch.models.unet",
    "cbim_tpu_torch.models.attention_unet",
    "cbim_tpu_torch.models.unetpp",
    "cbim_tpu_torch.models.vnet",
    "cbim_tpu_torch.models.daunet",
    "cbim_tpu_torch.models.transunet",
    "cbim_tpu_torch.inference.engines",
    "cbim_tpu_torch.inference.export",
    "cbim_tpu_torch.parallel",
    "cbim_tpu_torch.parallel.collectives",
    "cbim_tpu_torch.parallel.mesh",
    "cbim_tpu_torch.parallel.spatial",
    "cbim_tpu_torch.prediction",
    "cbim_tpu_torch.utils.jax_import",
    "cbim_tpu_torch.utils.flax_msgpack",
    "cbim_tpu_torch.data.nifti",
    "cbim_tpu_torch.data.conversion",
    "cbim_tpu_torch.data.conversion.utils",
    "cbim_tpu_torch.data.conversion.convert",
    "cbim_tpu_torch.data.base",
    "cbim_tpu_torch.data.datasets",
    "cbim_tpu_torch.data.factory",
    "cbim_tpu_torch.data.pipeline",
    "cbim_tpu_torch.data.native",
    "cbim_tpu_torch.training",
    "cbim_tpu_torch.training.schedules",
    "cbim_tpu_torch.training.optim",
    "cbim_tpu_torch.training.train_state",
    "cbim_tpu_torch.training.checkpoint",
    "cbim_tpu_torch.training.trainer",
    "cbim_tpu_torch.training.pretrained",
    "cbim_tpu_torch.training.validation",
    "cbim_tpu_torch.train",
    "cbim_tpu_torch.utils.logging",
    "cbim_tpu_torch.utils.profiling",
    "cbim_tpu_torch.tools",
    "cbim_tpu_torch.tools.probe_bandwidth",
    "cbim_tpu_torch.tools.probe_lhst_dot",
    "cbim_tpu_torch.tools.probe_conv_dissect",
    "cbim_tpu_torch.tools.converge",
    "cbim_tpu_torch.tools.export_model",
]

#: what the port may load of cbim_tpu: nothing
ALLOWED = []

_PROBE = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["msgpack"] = None
importlib.import_module({mod!r})
{extra}
leaked = sorted(m for m in sys.modules
                if (m == "cbim_tpu" or m.startswith("cbim_tpu."))
                and m not in {allowed!r})
assert not leaked, leaked
print("ok")
"""


def _probe(mod, extra=""):
    code = _PROBE.format(mod=mod, extra=extra, allowed=ALLOWED)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


#: reads module names, one a line; for each forks a child that imports it
#: and reports "ok", the leaked cbim_tpu modules or the traceback, as one
#: JSON line
_FORK_SERVER = r"""
import importlib, json, os, sys, traceback
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["msgpack"] = None
import numpy, torch
assert not any(m.split(".")[0] in ("cbim_tpu", "cbim_tpu_torch")
               for m in sys.modules)
for line in sys.stdin:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            importlib.import_module(line.strip())
            leaked = sorted(m for m in sys.modules
                            if (m == "cbim_tpu" or m.startswith("cbim_tpu."))
                            and m not in {allowed!r})
            msg = "ok" if not leaked else f"loaded {{leaked}}"
        except BaseException:
            msg = traceback.format_exc()
        os.write(w, msg.encode())
        os._exit(0)
    os.close(w)
    out = b""
    while True:
        chunk = os.read(r, 65536)
        if not chunk:
            break
        out += chunk
    os.close(r)
    os.waitpid(pid, 0)
    print(json.dumps(out.decode()), flush=True)
"""


@pytest.fixture(scope="module")
def importer():
    """``importer(mod)``: the fork server's answer for ``mod`` (120 s at
    most)."""
    server = subprocess.Popen(
        [sys.executable, "-c", _FORK_SERVER.format(allowed=ALLOWED)],
        cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def ask(mod: str) -> str:
        server.stdin.write(mod + "\n")
        server.stdin.flush()
        ready, _, _ = select.select([server.stdout], [], [], 120)
        assert ready, f"no answer for {mod} in 120 s"
        line = server.stdout.readline()
        assert line, server.stderr.read()
        return json.loads(line)

    yield ask
    server.stdin.close()
    server.wait(timeout=60)


@pytest.mark.parametrize("mod", MODULES)
def test_module_imports_without_jax(mod, importer):
    assert importer(mod) == "ok"


def test_prediction_main_loads_only_the_allowed_host_modules(tmp_path):
    """``prediction.main`` imports its host modules (NIfTI I/O, resampling)
    inside the call; serve one off-spacing 2D request with a tiny model to
    its end on the CPU with jax blocked: it loads no ``cbim_tpu`` module."""
    cfg = dict(dataset="synthetic", model="medformer", dimension="2d",
               classes=2, in_chan=1, base_chan=4, map_size=1,
               conv_block="BasicBlock", conv_num=[1, 0, 0, 0, 0, 0, 1, 1],
               trans_num=[0, 1, 1, 1, 1, 1, 0, 0],
               num_heads=[1, 2, 2, 2, 2, 2, 1, 1], expansion=2,
               fusion_depth=1, fusion_dim=16, fusion_heads=2,
               proj_type="depthwise", aux_loss=True, training_size=[16, 16])
    extra = (
        "import numpy as np, torch\n"
        "from cbim_tpu_torch.config import config_from_dict\n"
        "from cbim_tpu_torch.data.nifti import write_nifti\n"
        "from cbim_tpu_torch.models import get_model\n"
        f"cfg = config_from_dict({cfg!r})\n"
        f"w = {str(tmp_path / 'w.pth')!r}\n"
        "torch.save(get_model(cfg, device='cpu').state_dict(), w)\n"
        f"write_nifti({str(tmp_path / 'a.nii.gz')!r}, np.ones((2, 12, 20),"
        " np.float32), spacing=(4.0, 0.9, 0.9))\n"
        "sec = prediction.main(['--dataset', 'synthetic', '--dimension', '2d',"
        f" '--model', 'medformer', '--load', w, '--img_path', {str(tmp_path)!r},"
        f" '--save_path', {str(tmp_path / 'out')!r}, '--target_spacing',"
        " '1.0,1.0', '--device', 'cpu'], cfg=cfg)\n"
        "assert list(sec) == ['a.nii.gz'], sec")
    extra = "from cbim_tpu_torch import prediction\n" + extra
    proc = _probe("cbim_tpu_torch.prediction", extra)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), \
        proc.stderr[-2000:]


def test_train_main_runs_without_jax(tmp_path):
    """``train.main`` imports its modules inside the call; run a tiny
    config to its end on the CPU with jax blocked, its epoch ending in an
    evaluation (metrics, distances) of its one test volume."""
    cfg = dict(dataset="synthetic", model="medformer", dimension="3d",
               classes=2, base_chan=4, chan_num=[8, 8, 16, 16, 16, 8, 8, 4],
               map_size=[1, 1, 1], conv_block="BasicBlock",
               conv_num=[1, 0, 0, 0, 0, 0, 1, 1],
               trans_num=[0, 1, 1, 1, 1, 1, 0, 0],
               num_heads=[1, 2, 2, 2, 2, 2, 1, 1], fusion_depth=1,
               fusion_dim=16, fusion_heads=2, expansion=2,
               proj_type="depthwise", norm="in", act="gelu",
               kernel_size=[[3, 3, 3]] * 5, down_scale=[[2, 2, 2]] * 4,
               aux_loss=True, aux_weight=[0.5, 0.5], training_size=[16] * 3,
               synthetic_cases=2, synthetic_shape=[20] * 3, k_fold=2,
               sliding_window=True, window_size=[16] * 3,
               affine_pad_size=[4] * 3, optimizer="adamw", base_lr=1e-3,
               epochs=1, iter_per_epoch=1, val_freq=1, ema=True)
    extra = ("from cbim_tpu_torch import train\n"
             "from cbim_tpu_torch.config import config_from_dict\n"
             f"train.main(['--batch_size', '1', '--cp_path', {str(tmp_path)!r},"
             f" '--log_path', {str(tmp_path)!r}, '--folds', '1',"
             f" '--device', 'cpu'], cfg=config_from_dict({cfg!r}))\n"
             "import os\n"
             f"assert os.path.exists(os.path.join({str(tmp_path)!r},"
             " 'synthetic', 'test', 'fold_0_best.ckpt'))")
    proc = _probe("cbim_tpu_torch.train", extra)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), \
        proc.stderr[-2000:]


def test_chip_smoke_needs_a_card_and_imports_no_jax():
    """Without CUDA the smoke script exits non-zero and prints no result;
    with jax blocked it still gets that far."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run")
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.argv = ['chip_smoke.py']; "
            "runpy.run_path('chip_smoke.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
