"""How far fp32 is from fp64 on the tiny ResUNet-3D of
``tests/test_torch_unet3d.py``: the numbers its tolerances rest on.

Run on the CPU (not a test; pytest does not collect it):

    JAX_PLATFORMS=cpu python tests/fp64_conditioning.py

It evaluates the JAX model in fp64 (x64 on, the InstanceNorm's fp32 cast
lifted to fp64 inside this process), then prints, against it:

- the eval softmax of the JAX fp32 model and of the port (fp32, the
  kernels' plain versions) at N(0, 1/fan_in) weights and at the port's
  default init;
- the step-0 gradient of the trajectories' loss, JAX fp32 and port fp32,
  each tensor's largest error as a share of its largest entry.
"""

import os
import sys
import types

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cbim_tpu.models.layers.convs as jax_convs  # noqa: E402
from cbim_tpu.models.unet import UNet3D as JaxUNet3D  # noqa: E402
from cbim_tpu.ops import losses as jax_losses  # noqa: E402
from cbim_tpu_torch.config import config_from_dict  # noqa: E402
from cbim_tpu_torch.models import get_model  # noqa: E402
from cbim_tpu_torch.ops import losses  # noqa: E402
from test_torch_swin_unetr import jax_params  # noqa: E402
from test_torch_unet3d import (FWD_SHAPE, TRAJ_SHAPE, _case, _x,  # noqa: E402
                               port_params_in_jax, trajectory_batches)


class _Float64Numpy(types.ModuleType):
    """``jax.numpy`` with ``float32`` meaning float64, for the JAX
    package's InstanceNorm, which casts to float32 by name."""

    def __getattr__(self, name):
        return getattr(jnp, name)


def jax_model(d, dtype):
    return JaxUNet3D(num_classes=d["classes"], base_ch=d["base_chan"],
                     block=d["block"], norm="in", dtype=dtype)


def evaluate(fn, *args, fp64=False):
    """``fn(*args)`` with the JAX InstanceNorm in fp64 when ``fp64``."""
    real = jax_convs.jnp
    if fp64:
        shim = _Float64Numpy("jnp64")
        shim.float32 = jnp.float64
        jax_convs.jnp = shim
    try:
        return jax.tree.map(np.asarray, fn(*args))
    finally:
        jax_convs.jnp = real


def softmax_errors(d, params, x):
    sm = {}
    for name, dt in (("fp32", jnp.float32), ("fp64", jnp.float64)):
        jm = jax_model(d, dt)
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), params)
        sm[name] = evaluate(lambda: jax.nn.softmax(
            jm.apply({"params": p}, jnp.asarray(x, dt)), -1),
            fp64=dt == jnp.float64)
    _, _, _, to_sd = _case("resunet")
    model = get_model(config_from_dict(d), device="cpu")
    model.load_state_dict(to_sd(params))
    with torch.inference_mode():
        port = torch.softmax(model(torch.from_numpy(x).movedim(-1, 1)), 1)
    port = port.movedim(1, -1).numpy()
    return (float(np.abs(sm["fp32"] - sm["fp64"]).max()),
            float(np.abs(port - sm["fp64"]).max()))


def gradient_errors(d, params):
    imgs, labs = trajectory_batches(TRAJ_SHAPE, d["classes"])
    grads = {}
    for name, dt in (("fp32", jnp.float32), ("fp64", jnp.float64)):
        jm = jax_model(d, dt)
        p = jax.tree.map(lambda a: jnp.asarray(a, dt), params)
        w = jnp.asarray(d["weight"], dt)

        def loss(p, jm=jm, dt=dt, w=w):
            out = jm.apply({"params": p}, jnp.asarray(imgs[0], dt),
                           train=True)
            return jax_losses.deep_supervision_loss(
                [out], jnp.asarray(labs[0]), [1.0], w, 1.0)

        grads[name] = evaluate(jax.grad(loss), p, fp64=dt == jnp.float64)
    _, _, _, to_sd = _case("resunet")
    model = get_model(config_from_dict(d), device="cpu", train=True)
    model.load_state_dict(to_sd(params))
    out = model(torch.from_numpy(imgs[0]).movedim(-1, 1))
    losses.deep_supervision_loss([out], torch.from_numpy(labs[0]), [1.0],
                                 d["weight"], 1.0).backward()
    ref = {k: v.double() for k, v in to_sd(jax.tree.map(
        lambda a: a.astype(np.float32), grads["fp64"])).items()}
    j32 = to_sd(grads["fp32"])
    rows = []
    for k, p in model.named_parameters():
        scale = float(ref[k].abs().max())
        rows.append((k, float((j32[k].double() - ref[k]).abs().max()) / scale,
                     float((p.grad.double() - ref[k]).abs().max()) / scale))
    return rows


def main():
    d, jm, to_jax, _ = _case("resunet")
    x = _x((*FWD_SHAPE, 1), 2)
    drawn = jax_params(jm, (*FWD_SHAPE, 1), seed=1)
    default = port_params_in_jax(d, jm, to_jax, 1)
    for name, params in (("N(0, 1/fan_in)", drawn), ("default init", default)):
        jax_err, port_err = softmax_errors(d, params, x)
        print(f"eval softmax at {name} weights, max abs error against fp64: "
              f"JAX fp32 {jax_err:.2e}, port fp32 {port_err:.2e}")
    rows = gradient_errors(d, port_params_in_jax(d, jm, to_jax, 3,
                                                 TRAJ_SHAPE))
    print("step-0 gradient, largest error against fp64 as a share of the "
          "tensor's largest entry (JAX fp32, port fp32):")
    for k, j, p in rows:
        print(f"  {k:45s} {j:.2e} {p:.2e}")
    print(f"worst: JAX fp32 {max(r[1] for r in rows):.2e}, port fp32 "
          f"{max(r[2] for r in rows):.2e}")


if __name__ == "__main__":
    main()
