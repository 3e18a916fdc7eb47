"""Batched on-device augmentation ops (counterpart of
``cbim_tpu/ops/augment.py``), the ops of the synthetic recipes:
``gaussian_noise``, ``brightness_multiply``, ``random_theta_3d`` and
``random_theta_2d``.  The other ten ops of the JAX package (additive
brightness, gamma, contrast, blur, mirror, elastic, ...) are queued in
ROADMAP.md.

Every op acts on a batch, img (B, *spatial, C), and draws from an explicit
``torch.Generator``: per-voxel noise from one on the image's device, the
per-sample scalars from one on the CPU (no device sync).  The JAX package's
PRNG streams differ, so the draws match in distribution only;
:func:`theta_3d_from_draws` and :func:`theta_2d_from_draws` build the
affines from given numbers so a test can feed them the JAX draws.
"""

from __future__ import annotations

import math

import torch


def gaussian_noise(img: torch.Tensor, gen: torch.Generator, std: float,
                   mean: float = 0.0) -> torch.Tensor:
    """augmentation.py:15 — iid gaussian noise."""
    noise = torch.randn(img.shape, generator=gen, device=img.device,
                        dtype=img.dtype)
    return img + noise * std + mean


def brightness_multiply(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """augmentation.py:84 — one multiplicative scalar per sample; factor
    (B,) drawn by :func:`draw_uniform`."""
    return img * factor.to(img.device, img.dtype).view(-1, *[1] * (img.dim() - 1))


def draw_uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    """n draws of U(lo, hi) on the generator's (CPU) device, fp32."""
    return torch.rand(n, generator=gen) * (hi - lo) + lo


def _aslist(v, n):
    if isinstance(v, (int, float)):
        return [float(v)] * n
    return [float(t) for t in v]


def theta_3d_from_draws(scales, shears, translates, degrees) -> torch.Tensor:
    """The (B, 3, 4) affine of ``random_theta_3d`` from its drawn numbers:
    scales (B, 3) = (sx, sy, sz), shears (B, 6) = (xy, xz, yx, yz, zx, zy),
    translates (B, 3), degrees (B, 3) integer rotations about x, y, z.
    theta = Rx @ Ry @ Rz @ S in fp32, rows (x, y, z) as ``F.affine_grid``
    reads them (the reference's composition, augmentation.py:192-291)."""
    scales, shears, translates, degrees = (
        torch.as_tensor(t, dtype=torch.float32)
        for t in (scales, shears, translates, degrees))
    B = scales.shape[0]
    s = torch.zeros(B, 4, 4)
    s[:, 0, 0], s[:, 1, 1], s[:, 2, 2], s[:, 3, 3] = (
        scales[:, 0], scales[:, 1], scales[:, 2], 1.0)
    s[:, 0, 1], s[:, 0, 2] = shears[:, 0], shears[:, 1]
    s[:, 1, 0], s[:, 1, 2] = shears[:, 2], shears[:, 3]
    s[:, 2, 0], s[:, 2, 1] = shears[:, 4], shears[:, 5]
    s[:, :3, 3] = translates
    ang = degrees / 180.0 * math.pi
    c, sn = torch.cos(ang), torch.sin(ang)
    rx = torch.zeros(B, 4, 4)
    rx[:, 0, 0] = rx[:, 3, 3] = 1.0
    rx[:, 1, 1], rx[:, 1, 2], rx[:, 2, 1], rx[:, 2, 2] = (
        c[:, 0], -sn[:, 0], sn[:, 0], c[:, 0])
    ry = torch.zeros(B, 4, 4)
    ry[:, 1, 1] = ry[:, 3, 3] = 1.0
    ry[:, 0, 0], ry[:, 0, 2], ry[:, 2, 0], ry[:, 2, 2] = (
        c[:, 1], -sn[:, 1], sn[:, 1], c[:, 1])
    rz = torch.zeros(B, 4, 4)
    rz[:, 2, 2] = rz[:, 3, 3] = 1.0
    rz[:, 0, 0], rz[:, 0, 1], rz[:, 1, 0], rz[:, 1, 1] = (
        c[:, 2], -sn[:, 2], sn[:, 2], c[:, 2])
    return (rx @ ry @ rz @ s)[:, :3, :]


def random_theta_3d(gen: torch.Generator, n: int, scale=0.3, rotate=45,
                    translate=0.1, shear=0.05) -> torch.Tensor:
    """n random affines (n, 3, 4) from ``gen`` (CPU), the distributions of
    the JAX package's ``random_theta_3d``: scales U(1-s, 1/(1-s)) (1 where
    s = 0), shears U(-sh, sh), translations U(-t, t) (0 where t = 0), and
    integer-degree rotations drawn from [-r, max(r, 1))."""
    scale, rotate = _aslist(scale, 3), _aslist(rotate, 3)
    translate, shear = _aslist(translate, 3), _aslist(shear, 3)
    scales = torch.stack([
        draw_uniform(gen, n, 1 - s, 1.0 / (1 - s)) if s > 0 else torch.ones(n)
        for s in scale], dim=1)
    shears = torch.stack([draw_uniform(gen, n, -shear[i // 2], shear[i // 2])
                          for i in range(6)], dim=1)
    translates = torch.stack([
        draw_uniform(gen, n, -t, t) if t > 0 else torch.zeros(n)
        for t in translate], dim=1)
    degrees = torch.stack([
        torch.randint(-int(r), max(int(r), 1), (n,), generator=gen).float()
        for r in rotate], dim=1)
    return theta_3d_from_draws(scales, shears, translates, degrees)


def theta_2d_from_draws(scales, shears, translates, degrees) -> torch.Tensor:
    """The (B, 2, 3) affine of ``random_theta_2d`` from its drawn numbers:
    scales (B, 2) = (sx, sy), shears (B, 2) = (shx, shy), translates (B, 2),
    degrees (B,) integer rotations.  theta = S @ R in fp32, rows (x, y) as
    ``F.affine_grid`` reads them: the 2D reference scales after rotating,
    unlike the 3D one (augmentation.py, random_scale_rotate_translate_2d)."""
    scales, shears, translates, degrees = (
        torch.as_tensor(t, dtype=torch.float32)
        for t in (scales, shears, translates, degrees))
    B = scales.shape[0]
    s = torch.zeros(B, 3, 3)
    s[:, 0, 0], s[:, 0, 1], s[:, 0, 2] = scales[:, 0], shears[:, 0], translates[:, 0]
    s[:, 1, 0], s[:, 1, 1], s[:, 1, 2] = shears[:, 1], scales[:, 1], translates[:, 1]
    s[:, 2, 2] = 1.0
    ang = degrees / 180.0 * math.pi
    c, sn = torch.cos(ang), torch.sin(ang)
    r = torch.zeros(B, 3, 3)
    r[:, 0, 0], r[:, 0, 1], r[:, 1, 0], r[:, 1, 1] = c, -sn, sn, c
    r[:, 2, 2] = 1.0
    return (s @ r)[:, :2, :]


def random_theta_2d(gen: torch.Generator, n: int, scale=0.3, rotate=180,
                    translate=0.0) -> torch.Tensor:
    """n random 2D affines (n, 2, 3) from ``gen`` (CPU), the distributions
    of the JAX package's ``random_theta_2d``: scales U(1-s, 1+s), shears
    drawn from the scale ranges U(-s, s), translations U(-t, t), and an
    integer-degree rotation drawn from [-r, max(r, 1))."""
    scale, translate = _aslist(scale, 2), _aslist(translate, 2)
    scales = torch.stack([draw_uniform(gen, n, 1 - s, 1 + s) for s in scale],
                         dim=1)
    shears = torch.stack([draw_uniform(gen, n, -s, s) for s in scale], dim=1)
    translates = torch.stack([draw_uniform(gen, n, -t, t) for t in translate],
                             dim=1)
    degrees = torch.randint(-int(rotate), max(int(rotate), 1), (n,),
                            generator=gen).float()
    return theta_2d_from_draws(scales, shears, translates, degrees)
