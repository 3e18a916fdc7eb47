"""The kernels as ``torch.library`` custom ops (``ops/kernels/_library.py``),
on the CPU: ``torch.library.opcheck`` of every ``cbim`` op in both dtypes
(its schema, its fake implementation's shapes, dtypes and strides against
the CPU implementation, its behaviour under AOT dispatch), the exported
graphs of a tiny MedFormer-3D and a tiny SwinUNETR holding the ops they
reach, and a training step of a tiny InstanceNorm UNet-3D through the ops
against the JAX package's ``make_train_step``.

``chip_smoke.py`` runs the same opcheck on the card, where the ops' CUDA
implementations launch the kernels.
"""

import collections
import io

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import conftest  # noqa: F401  (JAX on the CPU)
from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.inference.export import export_window_forward
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.ops.kernels import _library
from test_torch_threads import few_torch_threads  # noqa: F401
from test_torch_unet3d import _case, check_train, routed, TRAJ_STEPS

#: the ops of the model-path kernels, one per public kernel function
OPS = ("conv3d_same", "conv3d_dgrad", "conv3d_wgrad", "conv3d_same_na",
       "conv3d_wgrad_na", "conv2d_same", "conv2d_dgrad", "conv2d_wgrad",
       "inorm_stats", "inorm_apply", "inorm_bwd_stats", "inorm_bwd_apply",
       "window_attention")


def test_every_kernel_function_is_an_op():
    assert set(_library.OPS) == set(OPS)
    for name in OPS:
        assert hasattr(torch.ops.cbim, name), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", OPS)
def test_opcheck(name, dtype):
    torch.library.opcheck(_library.OPS[name],
                          _library.sample_args(name, dtype, "cpu"))


def cbim_ops(data: bytes) -> set:
    """The ``cbim`` ops that an artifact's graphs call, those under the
    autocast wrapper's submodules included."""
    ep = torch.export.load(io.BytesIO(data))
    found = set()
    for module in ep.graph_module.modules():
        graph = getattr(module, "graph", None)
        for node in (graph.nodes if graph is not None else ()):
            if (node.op == "call_function"
                    and getattr(node.target, "namespace", None) == "cbim"):
                found.add(node.target._opname)
    return found


def test_medformer_export_holds_its_ops():
    from test_torch_medformer import TINY
    cfg = config_from_dict(dict(TINY, training_size=[32] * 3,
                                window_size=[32] * 3, sliding_window=True))
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    ops = cbim_ops(export_window_forward(model, cfg, (32, 32, 32), 1,
                                         device="cpu"))
    assert ops == {"conv3d_same", "inorm_stats", "inorm_apply"}, ops


def test_swin_unetr_export_holds_its_ops():
    from test_torch_swin_unetr import TINY
    cfg = config_from_dict(dict(TINY, window_size=[32] * 3,
                                sliding_window=True))
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    ops = cbim_ops(export_window_forward(model, cfg, (32, 32, 32), 1,
                                         device="cpu"))
    # its convs and affine InstanceNorms are torch's (MONAI's blocks)
    assert ops == {"window_attention"}, ops


class _OpCounts(TorchDispatchMode):
    """Counts the ``cbim`` ops dispatched under it, by name."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "cbim":
            self.counts[func._opname] += 1
        return func(*args, **(kwargs or {}))


def test_unet3d_train_step_through_the_ops_matches_jax():
    """A tiny InstanceNorm UNet-3D's SGD trajectory (``check_train`` of
    ``tests/test_torch_unet3d.py``: the step-0 gradients, the losses, the
    params and EMA params against ``make_train_step``, at its tolerances)
    with every 3^3 conv and InstanceNorm going through the ops: per routed
    conv (the 1-channel stem conv is torch's) a forward, an input gradient
    and a wgrad op each pass; per InstanceNorm the four norm ops."""
    d, jm, to_jax, to_sd = _case("unet")
    with _OpCounts() as mode:
        check_train(d, jm, to_jax, to_sd)
    n_conv, n_norm = routed(get_model(config_from_dict(d), device="cpu"))
    # the trajectory's steps and check_trajectory's gradient pass
    passes = TRAJ_STEPS + 1
    assert mode.counts == {
        "conv3d_same": n_conv * passes, "conv3d_wgrad": n_conv * passes,
        "conv3d_dgrad": n_conv * passes,
        "inorm_stats": n_norm * passes, "inorm_apply": n_norm * passes,
        "inorm_bwd_stats": n_norm * passes,
        "inorm_bwd_apply": n_norm * passes}, (mode.counts, n_conv, n_norm)
