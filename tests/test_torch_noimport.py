"""The port runs without JAX: every module imports with ``jax`` and
``flax`` blocked, and of the JAX package ``cbim_tpu`` it pulls in only the
numpy/scipy host modules ``data.nifti`` and ``data.conversion.utils`` (and
the packages above them)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "cbim_tpu_torch",
    "cbim_tpu_torch.config",
    "cbim_tpu_torch.ops._backend",
    "cbim_tpu_torch.ops.activations",
    "cbim_tpu_torch.ops.interpolate",
    "cbim_tpu_torch.ops.kernels",
    "cbim_tpu_torch.ops.kernels._build",
    "cbim_tpu_torch.ops.kernels.conv3d",
    "cbim_tpu_torch.ops.kernels.fused_norm",
    "cbim_tpu_torch.models",
    "cbim_tpu_torch.models.layers.convs",
    "cbim_tpu_torch.models.layers.transformers",
    "cbim_tpu_torch.models.medformer",
    "cbim_tpu_torch.inference.engines",
    "cbim_tpu_torch.prediction",
    "cbim_tpu_torch.utils.jax_import",
    "cbim_tpu_torch.data.nifti",
]

#: what the port may load of cbim_tpu: the two host modules and their parents
ALLOWED = ["cbim_tpu", "cbim_tpu.data", "cbim_tpu.data.factory",
           "cbim_tpu.data.nifti", "cbim_tpu.data.conversion",
           "cbim_tpu.data.conversion.utils"]

_PROBE = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
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


@pytest.mark.parametrize("mod", MODULES)
def test_module_imports_without_jax(mod):
    proc = _probe(mod)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_prediction_main_loads_only_the_allowed_host_modules():
    """``prediction.main`` imports its host modules inside the call; parse
    its arguments up to the point where those imports have run."""
    extra = ("from cbim_tpu_torch import prediction\n"
             "try:\n"
             "    prediction.main(['--img_path', '.', '--device', 'cpu',\n"
             "                     '--dimension', '2d'])\n"
             "except NotImplementedError:\n"
             "    pass\n"
             "assert 'cbim_tpu.data.conversion.utils' in sys.modules")
    proc = _probe("cbim_tpu_torch.prediction", extra)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


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
