"""Batched on-device augmentation ops (counterpart of
``cbim_tpu/ops/augment.py``): every op of the JAX package's module.

Intensity: ``gaussian_noise`` (and ``add_noise`` for a given noise tensor
and per-sample std, the recipes' ``std_range`` noise),
``brightness_additive``, ``brightness_multiply``, ``gamma`` (with the
masked statistics of the full-volume path), ``contrast`` and
``gaussian_blur``.  Spatial: ``mirror``, ``elastic_deform`` (3D or 2D by
the label's rank: the JAX package's ``elastic_deform_3d/2d``), the crops
(``center_crop``: its ``center_crop_3d/2d``; ``crop_at`` from
``random_crop_starts``: its ``random_crop_3d/2d``;
``crop_around_coordinate_3d``) and the affines (``random_theta_3d/2d``).
Of the spatial ops the pipeline runs ``mirror``, ``elastic_deform`` (a
recipe's opt-in ``elastic``) and the affines; the crops are the JAX
module's surface, held against it by the tests, with no caller in the
pipeline (its crop is fused into the resample).

Every op acts on a batch, img (B, *spatial, C), lab (B, *spatial), where
the JAX package vmaps a single-sample op: statistics (min, max, mean,
unbiased std) are taken per sample, never over the batch.  Each op takes
its per-sample scalars already drawn, as (B,) tensors on the image's
device, so a test can feed it the JAX draws; the pipeline draws them from
a ``torch.Generator`` on the CPU (no device sync), and per-voxel noise
from one on the image's device.  The JAX package's PRNG streams differ, so
the pipeline's draws match in distribution only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .resample import linear_gather, nearest_gather


def _per_sample(v, img: torch.Tensor, dtype=None) -> torch.Tensor:
    """A per-sample scalar (B,) (or a Python number) shaped to broadcast
    over img (B, *spatial, C)."""
    v = torch.as_tensor(v, device=img.device, dtype=dtype or img.dtype)
    return v.view(-1, *[1] * (img.dim() - 1)) if v.dim() else v


def _sample_dims(x: torch.Tensor) -> tuple:
    return tuple(range(1, x.dim()))


# ---------------------------------------------------------------------------
# intensity ops  (reference training/augmentation.py:15-167)
# ---------------------------------------------------------------------------


def gaussian_noise(img: torch.Tensor, gen: torch.Generator, std,
                   mean: float = 0.0) -> torch.Tensor:
    """augmentation.py:15 — iid gaussian noise drawn from ``gen`` (on the
    image's device) in the image's dtype, as the JAX package draws it."""
    noise = torch.randn(img.shape, generator=gen, device=img.device,
                        dtype=img.dtype)
    return add_noise(img, noise, std, mean)


def add_noise(img: torch.Tensor, noise: torch.Tensor, std,
              mean: float = 0.0) -> torch.Tensor:
    """img + noise * std + mean; ``std`` a number or per-sample (B,) (the
    ``std_range`` recipes draw it per sample, pipeline.py:91-96)."""
    return img + noise * _per_sample(std, img) + mean


def brightness_additive(img: torch.Tensor, shift) -> torch.Tensor:
    """augmentation.py:67 — one additive scalar per sample (per_channel
    False); shift (B,) = N(0, 1) * std + mean."""
    return img + _per_sample(shift, img)


def brightness_multiply(img: torch.Tensor, factor) -> torch.Tensor:
    """augmentation.py:84 — one multiplicative scalar per sample; factor
    (B,) drawn by :func:`draw_uniform`."""
    return img * _per_sample(factor, img)


def draw_uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    """n draws of U(lo, hi) on the generator's (CPU) device, fp32."""
    return torch.rand(n, generator=gen) * (hi - lo) + lo


def _std_unbiased(x: torch.Tensor) -> torch.Tensor:
    dims = _sample_dims(x)
    n = math.prod(x.shape[1:])
    mu = x.mean(dims, keepdim=True)
    return torch.sqrt(((x - mu) ** 2).sum(dims, keepdim=True) / (n - 1))


def _masked_stats(x: torch.Tensor, mask: torch.Tensor, count: torch.Tensor):
    """Per-sample (min, max, mean, unbiased std) over the ``mask``-selected
    voxels; ``count`` (B,) is the number selected."""
    dims = _sample_dims(x)
    big = 3.4e38
    count = _per_sample(count, x, torch.float32)
    minm = torch.where(mask, x, big).amin(dims, keepdim=True)
    maxm = torch.where(mask, x, -big).amax(dims, keepdim=True)
    mean = torch.where(mask, x, 0.0).sum(dims, keepdim=True) / count
    var = torch.where(mask, (x - mean) ** 2, 0.0).sum(dims, keepdim=True) \
        / (count - 1)
    return minm, maxm, mean, torch.sqrt(var)


def gamma(img: torch.Tensor, g, retain_stats: bool = True, mask=None,
          count=None) -> torch.Tensor:
    """augmentation.py:104-136 — per-sample min-max renorm, ``pow`` by the
    drawn g (B,), optional retention of the mean and unbiased std.

    per_channel=False: a sample's statistics and g are shared across its
    channels.  A constant sample is left as it is (the reference NaNs
    there).  The pow is NaN-proof: 0 (or any fp-edge negative) base gives
    exactly 0.  ``mask`` (B, *spatial, 1) and ``count`` (B,) restrict the
    statistics to the true volume inside a zero-padded cache row (the
    full-volume path), whose padding comes out 0."""
    g = _per_sample(g, img, torch.float32)
    x = img.float()
    dims = _sample_dims(x)
    if mask is not None:
        minm, maxm, mean, std = _masked_stats(x, mask, count)
    else:
        minm = x.amin(dims, keepdim=True)
        maxm = x.amax(dims, keepdim=True)
        mean = x.mean(dims, keepdim=True)
        std = _std_unbiased(x)
    rng = maxm - minm
    safe_rng = torch.where(rng > 0, rng, 1.0)
    base = (x - minm) / safe_rng
    if mask is not None:
        base = torch.where(mask, base, 0.0)
    powed = torch.where(base > 0,
                        torch.exp(g * torch.log(base.clamp_min(1e-38))), 0.0)
    y = powed * rng + minm
    if retain_stats:
        if mask is not None:
            _, _, y_mean, new_std = _masked_stats(y, mask, count)
        else:
            y_mean = y.mean(dims, keepdim=True)
            new_std = _std_unbiased(y)
        y = y - y_mean
        y = y / torch.where(new_std > 0, new_std, 1.0) * std + mean
    if mask is not None:
        y = torch.where(mask, y, 0.0)
    return y.to(img.dtype)


def contrast(img: torch.Tensor, f, preserve_range: bool = True) -> torch.Tensor:
    """augmentation.py:138-167 — scale each sample around its mean by the
    drawn f (B,), clipped to the sample's original range."""
    f = _per_sample(f, img, torch.float32)
    x = img.float()
    dims = _sample_dims(x)
    mean = x.mean(dims, keepdim=True)
    y = (x - mean) * f + mean
    if preserve_range:
        y = torch.clamp(y, x.amin(dims, keepdim=True),
                        x.amax(dims, keepdim=True))
    return y.to(img.dtype)


def mirror(img: torch.Tensor, lab: torch.Tensor, axis: int):
    """augmentation.py:169-189 — flip spatial ``axis`` (0-based among the
    spatial axes, as the JAX op's single sample has it) of image and label:
    batch axis ``axis + 1``."""
    return torch.flip(img, (axis + 1,)), torch.flip(lab, (axis + 1,))


def blur_weights(sigma: torch.Tensor, hi: float) -> torch.Tensor:
    """(B, 2 ceil(3 hi) + 1) normalised 1D gaussian taps: a fixed support
    sized for the range's top, taps beyond each sample's ceil(3 sigma)
    zeroed before normalising: the reference's dynamic 2 ceil(3 s) + 1
    kernel."""
    m_max = int(math.ceil(3 * hi))
    offsets = torch.arange(-m_max, m_max + 1, dtype=torch.float32,
                           device=sigma.device)
    sigma = sigma.float()[:, None]
    m_dyn = torch.ceil(3.0 * sigma)
    w = torch.exp(-(offsets ** 2) / (2.0 * sigma ** 2))
    w = torch.where(offsets.abs() <= m_dyn, w, 0.0)
    return w / w.sum(1, keepdim=True)


def gaussian_blur(img: torch.Tensor, sigma, hi: float) -> torch.Tensor:
    """augmentation.py:19-64 — gaussian blur by each sample's drawn sigma
    (B,) from a range whose top is ``hi``: separable, zero-padded 1D passes
    along each spatial axis (the dense gaussian is the product of its
    normalised factors).  The passes are explicit shifted sums in fp32, so
    no TF32 convolution can round them (the JAX package runs its conv at
    fp32 HIGHEST)."""
    w = blur_weights(torch.as_tensor(sigma, device=img.device), hi)
    out = img.float()
    for axis in range(1, img.dim() - 1):
        out = _conv1d_along(out, w, axis)
    return out.to(img.dtype)


def _conv1d_along(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """Each sample's taps w (B, k) along batch ``axis`` of x, zero-padded."""
    k = w.shape[1]
    m = k // 2
    moved = x.movedim(axis, -1)                       # (B, ..., L)
    L = moved.shape[-1]
    padded = F.pad(moved, (m, m))
    wb = w.view(w.shape[0], *[1] * (moved.dim() - 1), k)
    out = wb[..., 0] * padded[..., 0:L]
    for t in range(1, k):
        out = out + wb[..., t] * padded[..., t:t + L]
    return out.movedim(-1, axis)


# ---------------------------------------------------------------------------
# affine theta builders  (reference augmentation.py:192-291)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# elastic deformation (an opt-in extra: the reference's augmentation is
# affine-only and no dataset recipe enables it; a recipe names it as
# ("elastic", p, {"grid": ..., "magnitude": ...}))
# ---------------------------------------------------------------------------


def elastic_field(disp: torch.Tensor, vol_shape, magnitude) -> torch.Tensor:
    """Smooth per-axis displacements in normalised units, (B, nd,
    *vol_shape) fp32: control points ``disp`` (B, nd, *grid) drawn from
    U(-1, 1), scaled per axis by ``magnitude`` and upsampled linearly with
    half-pixel centres along each axis in turn, as ``jax.image.resize(...,
    "linear")`` upsamples (an edge sample outside the grid takes the edge
    value); the coarse-to-fine interpolation is the smoothing.  Elementwise
    ops only, so the card and the CPU compute the same field bit for bit
    (a label's nearest voxel then never differs at a .5 tie)."""
    nd = len(vol_shape)
    mag = torch.as_tensor(magnitude, dtype=torch.float32,
                          device=disp.device).view(1, nd, *[1] * nd)
    out = disp.float() * mag
    for a, n_out in enumerate(vol_shape):
        out = _upsample_linear(out, a + 2, int(n_out))
    return out


def _upsample_linear(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """Linear resize of ``dim`` to ``n_out`` samples, half-pixel centres,
    clamped at the edges."""
    n_in = x.shape[dim]
    pos = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) \
        * (n_in / n_out) - 0.5
    lo = torch.floor(pos)
    frac = pos - lo
    i0 = lo.long().clamp(0, n_in - 1)
    i1 = (lo.long() + 1).clamp(0, n_in - 1)
    shape = [1] * x.dim()
    shape[dim] = n_out
    frac = frac.view(shape)
    return (x.index_select(dim, i0) * (1.0 - frac)
            + x.index_select(dim, i1) * frac)


def elastic_deform(img: torch.Tensor, lab: torch.Tensor, disp: torch.Tensor,
                   magnitude) -> tuple[torch.Tensor, torch.Tensor]:
    """Random smooth elastic deformation of a batch, 3D or 2D: img (B,
    *spatial, C), lab (B, *spatial), control points ``disp`` (B, nd,
    *grid) in [-1, 1].  ``magnitude`` (nd,) is the largest control-point
    displacement per axis in normalised half-extent units (0.05: up to
    ``0.05 (size - 1) / 2`` voxels).  Sampling follows grid_sample's
    conventions (zeros outside; the image (tri/bi)linear, labels nearest
    with ties to even)."""
    vol = tuple(lab.shape[1:])
    field = elastic_field(disp, vol, magnitude)
    coords = []
    for a, s in enumerate(vol):
        shape = [1] * len(vol)
        shape[a] = s
        base = torch.arange(s, dtype=torch.float32, device=img.device)
        coords.append(base.view(1, *shape) + field[:, a] * ((s - 1) / 2.0))
    return linear_gather(img, coords), nearest_gather(lab, coords)


# ---------------------------------------------------------------------------
# crops  (reference augmentation.py:297-382)
# ---------------------------------------------------------------------------

def crop_at(img: torch.Tensor, lab: torch.Tensor, starts, crop_size):
    """Each sample's ``crop_size`` box from its start (B, nd): (B, *crop,
    C), (B, *crop)."""
    starts = torch.as_tensor(starts).tolist()
    out_img, out_lab = [], []
    for b, st in enumerate(starts):
        box = tuple(slice(int(s), int(s) + c) for s, c in zip(st, crop_size))
        out_img.append(img[(b, *box)])
        out_lab.append(lab[(b, *box)])
    return torch.stack(out_img), torch.stack(out_lab)


def center_crop(img, lab, crop_size):
    """The centred box, start (size - crop) // 2 on each axis (3D or 2D by
    the length of ``crop_size``)."""
    starts = [(s - c) // 2 for s, c in zip(img.shape[1:], crop_size)]
    return crop_at(img, lab, [starts] * img.shape[0], crop_size)


def random_crop_starts(gen: torch.Generator, n: int, shape, crop_size):
    """n uniform crop starts (n, nd): randint(0, max(size - crop, 1)) per
    axis (the high end exclusive, as the reference's crop_3d)."""
    return torch.stack([
        torch.randint(0, max(s - c, 1), (n,), generator=gen)
        for s, c in zip(shape, crop_size)], dim=1)


def coordinate_crop_starts(coordinate, shape, crop_size, u=None,
                           mode: str = "random") -> torch.Tensor:
    """augmentation.py:346-382 — crop starts (B, 3) of boxes containing or
    near each sample's (z, y, x) point (B, 3).  'random': lo + u % (hi -
    lo) over the clamped neighbourhood, u (B, 3) the JAX op's draws from
    [0, 2^30); 'center': the point at the crop centre, clamped in-bounds."""
    p = torch.as_tensor(coordinate, dtype=torch.int64)
    starts = []
    for a, (c, s) in enumerate(zip(crop_size, shape)):
        if mode == "random":
            lo = torch.clamp(p[:, a] - c, min=0)
            hi = torch.clamp(p[:, a] + c, max=s - c)
            hi = torch.maximum(hi, lo + 1)
            starts.append(lo + torch.as_tensor(u, dtype=torch.int64)[:, a]
                          % (hi - lo))
        else:
            lo = torch.clamp(p[:, a] - (c + 1) // 2, min=0)
            starts.append(torch.clamp(lo, max=s - c))
    return torch.stack(starts, dim=1)


def crop_around_coordinate_3d(img, lab, crop_size, coordinate, u=None,
                              mode: str = "random"):
    """The crop of :func:`coordinate_crop_starts` around each sample's
    point."""
    starts = coordinate_crop_starts(coordinate, img.shape[1:4], crop_size, u,
                                    mode)
    return crop_at(img, lab, starts, crop_size)

