"""The port's route defaults follow the JAX package's, on the CPU.

- MedFormer-2D's 3x3 conv kernel (``Conv2dSame``) is opt-in behind the
  config key ``conv2d_kernel``, as JAX's ``_pallas_conv2d_usable`` runs only
  with ``CBIM_PLCONV2D=1``; the route is fixed when the model is built.
- MedFormer-3D trains with remat of every stage when the config has no
  ``remat`` key, as JAX's ``get_model`` (``remat=True``), and the port keeps
  its mode strings ('highres' stays 'highres').
"""

import pytest
import torch

from cbim_tpu_torch.config import config_from_dict
from cbim_tpu_torch.models import get_model
from cbim_tpu_torch.models.layers.convs import ConvNormAct
from cbim_tpu_torch.models.medformer import REMAT_MODES
from cbim_tpu_torch.ops.kernels import conv2d
from cbim_tpu_torch.ops.kernels.conv2d import Conv2dSame
from test_torch_medformer import TINY
from test_torch_medformer2d import ACDC, TINY2D
from test_torch_threads import few_torch_threads  # noqa: F401


def _eligible(m: ConvNormAct) -> bool:
    """A 3x3 ungrouped conv inside ``_pallas_conv2d_usable``'s envelope."""
    c = m.conv
    return (c.kernel_size == (3, 3) and c.groups == 1
            and c.in_channels <= 192 and c.out_channels <= 192)


def _sites(model):
    return [m for m in model.modules() if isinstance(m, ConvNormAct)]


@pytest.mark.parametrize("d", [TINY2D, ACDC])
def test_medformer2d_takes_the_kernel_route_only_with_the_key(d):
    """Default config: no ConvNormAct of MedFormer-2D routes through
    ``Conv2dSame``.  With ``conv2d_kernel: true`` every eligible 3x3 conv
    does, and no other."""
    assert config_from_dict(d).conv2d_kernel is False
    off = get_model(config_from_dict(d), device="cpu")
    assert _sites(off) and all(m.kernel is None for m in _sites(off))
    on = get_model(config_from_dict(dict(d, conv2d_kernel=True)), device="cpu")
    eligible = [m for m in _sites(on) if _eligible(m)]
    assert eligible
    for m in _sites(on):
        assert (m.kernel is Conv2dSame) == _eligible(m)


def test_medformer2d_routes_compute_the_same_function():
    """Same weights, key on and off: on the CPU both routes run
    ``F.conv2d`` (the kernel's plain version, or cuDNN's module call), so
    the eval forward and a train-mode gradient agree to fp32 rounding
    (1e-6), and no kernel launches."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 1, 32, 32, generator=gen)
    conv2d.launches.update(dict.fromkeys(conv2d.launches, 0))
    outs, grads = [], []
    for key in (False, True):
        cfg = config_from_dict(dict(TINY2D, conv2d_kernel=key))
        model = get_model(cfg, device="cpu", train=True,
                          generator=torch.Generator().manual_seed(1))
        model(x)[0].square().mean().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
        with torch.inference_mode():
            outs.append(model.eval()(x)[0])
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-6, atol=1e-6)
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-6, atol=1e-6)
    assert not any(conv2d.launches.values())


def test_medformer3d_remats_every_stage_without_a_remat_key():
    d = dict(TINY)
    d.pop("remat", None)
    assert get_model(config_from_dict(d), device="cpu",
                     train=True).remat == REMAT_MODES["all"]


@pytest.mark.parametrize("remat,mode", [(True, "all"), ("all", "all"),
                                        ("highres", "highres"),
                                        ("store-up4", "store-up4"),
                                        (False, "none")])
def test_medformer3d_keeps_its_remat_mode_strings(remat, mode):
    """An explicit key keeps its mode: JAX's ``bool(cfg.remat)`` would make
    'highres' 'all'; the port does not."""
    model = get_model(config_from_dict(dict(TINY, remat=remat)),
                      device="cpu", train=True)
    assert model.remat == REMAT_MODES[mode]
