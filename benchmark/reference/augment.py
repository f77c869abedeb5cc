"""Frozen copy, for the benchmark's reference, of the plain PyTorch code in
``nndetection_tpu_torch/data/augment.py``; it imports nothing of the program.

Data augmentation on the device (counterpart of
:mod:`nndetection_tpu.data.augment`, its gather branch).

The host memmaps enlarged raw patches (the generator patch of
:func:`get_generator_patch_size`); every transform runs on the device, per
sample: the affine rotation and scale about the patch centre, elastic
deformation, mirroring, Gaussian noise and blur, brightness, contrast,
low-resolution simulation and gamma. The affine resample always runs, with
an identity matrix when nothing fires, so that every sample takes the same
path. At an odd margin between the generator patch and the patch, that
identity samples at half-voxel coordinates: the data is interpolated
linearly between two voxels and the segmentation rounds half away from
zero, as in the JAX package.

The draws are split from the transform: :func:`sample_augment_params`
draws every random quantity from an explicit ``torch.Generator``, and
:func:`apply_augment` is deterministic, so that tests can give it the JAX
package's draws.

Rounding follows ``jax.scipy.ndimage.map_coordinates``: nearest indices
round half away from zero, linear corners are ``floor`` and ``floor + 1``,
corners outside the input take the constant (0 for data, -1 for the
segmentation), and the interpolated data is rounded to the input's dtype
before the intensity transforms promote it to float32. The sample
coordinates are computed as XLA's float32 dot computes them (a chain of
fused multiply-adds, emulated in float64), and the rotation matrix in
float64, so that the card and the CPU give the same coordinates.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class AugmentConfig:
    """The JAX package's ``AugmentConfig``, field for field. Ranges follow
    the ``base_more`` preset.

    ``use_mxu_resample`` stays so that configurations compare equal with the
    JAX package's; the port always gathers. The MXU shear chain exists
    because a TPU has no vector gather, and a GPU has one."""

    patch_size: Tuple[int, ...] = (96, 96, 96)
    # spatial
    p_rotation: float = 0.2
    rotation_deg: float = 30.0
    p_scale: float = 0.2
    scale_range: Tuple[float, float] = (0.7, 1.4)
    mirror_axes: Tuple[int, ...] = (0, 1, 2)
    # elastic deformation: smoothed uniform noise, alpha-scaled
    p_elastic: float = 0.0
    elastic_alpha: Tuple[float, float] = (0.0, 900.0)
    elastic_sigma: Tuple[float, float] = (9.0, 13.0)
    # anisotropic patches: spatial transforms act only in the (1, 2) plane
    dummy_2d: bool = False
    # zero the data where the segmentation is -1 (outside the
    # normalization mask) after the spatial transform
    mask_norm_zero: bool = False
    # intensity
    p_noise: float = 0.1
    noise_var: Tuple[float, float] = (0.0, 0.1)
    p_blur: float = 0.2
    blur_sigma: Tuple[float, float] = (0.5, 1.0)
    p_brightness: float = 0.15
    brightness_range: Tuple[float, float] = (0.75, 1.25)
    p_contrast: float = 0.15
    contrast_range: Tuple[float, float] = (0.75, 1.25)
    p_lowres: float = 0.25
    lowres_zoom: Tuple[float, float] = (0.5, 1.0)
    p_gamma: float = 0.3
    gamma_range: Tuple[float, float] = (0.7, 1.5)
    p_gamma_invert: float = 0.1
    use_mxu_resample: bool = True


def get_generator_patch_size(
    final_patch_size: Sequence[int],
    rotation_deg: float = 30.0,
    scale_min: float = 0.7,
    dummy_2d: bool = False,
) -> Tuple[int, ...]:
    """Enlarged host-side patch so that rotation and scale never sample
    outside it. In dummy-2D mode only the in-plane axes are enlarged."""
    ps = np.asarray(final_patch_size, dtype=np.float64)
    # worst-case in-range rotation: the |cos|+|sin| bound peaks at 45 deg
    rot = np.deg2rad(min(abs(rotation_deg), 45.0))
    out = ps.copy()
    dim = len(ps)
    if dummy_2d and dim == 3:
        a, b = 1, 2
        ca, sa = abs(np.cos(rot)), abs(np.sin(rot))
        out[a] = max(out[a], ca * ps[a] + sa * ps[b])
        out[b] = max(out[b], sa * ps[a] + ca * ps[b])
        out[1:] = out[1:] / scale_min
        return tuple(int(np.ceil(v)) for v in out)
    for axis in range(dim if dim == 3 else 1):
        # rotation around `axis` mixes the other two axes
        others = [i for i in range(dim) if i != axis] if dim == 3 else [0, 1]
        a, b = others
        ca, sa = abs(np.cos(rot)), abs(np.sin(rot))
        na = ca * ps[a] + sa * ps[b]
        nb = sa * ps[a] + ca * ps[b]
        out[a] = max(out[a], na)
        out[b] = max(out[b], nb)
    out = out / scale_min
    return tuple(int(np.ceil(v)) for v in out)


def generator_patch_size_for(cfg: AugmentConfig) -> Tuple[int, ...]:
    """Generator patch for a concrete augmentation config."""
    return get_generator_patch_size(
        cfg.patch_size,
        rotation_deg=cfg.rotation_deg,
        scale_min=cfg.scale_range[0],
        dummy_2d=cfg.dummy_2d,
    )


# ---------------------------------------------------------------- draws
@dataclass
class AugmentParams:
    """Every random quantity of one batch's augmentation, one row per
    sample: each transform's raw draw and its trigger (``do_*``, bool). The
    JAX package draws the same quantities, in ``augment_sample``."""

    angles: torch.Tensor  # [B, 3] in +-rotation_deg, radians
    do_rotation: torch.Tensor
    scale: torch.Tensor  # [B] in scale_range
    do_scale: torch.Tensor
    flips: torch.Tensor  # [B, dim] bool, p = 0.5 per axis
    noise_var: torch.Tensor
    noise: torch.Tensor  # [B, *patch, C] standard normal
    do_noise: torch.Tensor
    blur_sigma: torch.Tensor
    do_blur: torch.Tensor
    brightness: torch.Tensor
    do_brightness: torch.Tensor
    contrast: torch.Tensor
    do_contrast: torch.Tensor
    zoom: torch.Tensor
    do_lowres: torch.Tensor
    gamma: torch.Tensor
    gamma_invert: torch.Tensor
    do_gamma: torch.Tensor
    elastic_alpha: torch.Tensor
    elastic_sigma: torch.Tensor
    do_elastic: torch.Tensor
    # [B, dim, *lattice] in [-1, 1]; None when the config has no elastic
    elastic_noise: Optional[torch.Tensor] = None

    def to(self, device) -> "AugmentParams":
        return AugmentParams(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
            for f in fields(self)})


def elastic_lattice_shape(out_shape: Sequence[int], lattice_stride: int = 4) -> Tuple[int, ...]:
    """The stride-``lattice_stride`` lattice the elastic noise is drawn on."""
    return tuple(-(-s // lattice_stride) + 1 for s in out_shape)


def sample_augment_params(cfg: AugmentConfig, batch_size: int, channels: int,
                          generator: torch.Generator, device) -> AugmentParams:
    """Draw one batch's :class:`AugmentParams` from ``generator`` (which
    lives on ``device``), in the order of the fields. ``channels`` is the
    data's channel count, which the noise field covers."""
    out_shape = tuple(cfg.patch_size)
    dim = len(out_shape)
    b = batch_size

    def uniform(lo, hi, shape=()):
        u = torch.rand((b, *shape), generator=generator, device=device)
        return lo + (hi - lo) * u

    def trigger(p):
        return torch.rand((b,), generator=generator, device=device) < p

    max_rad = float(np.deg2rad(cfg.rotation_deg))
    draws = dict(
        angles=uniform(-max_rad, max_rad, (3,)), do_rotation=trigger(cfg.p_rotation),
        scale=uniform(*cfg.scale_range), do_scale=trigger(cfg.p_scale),
        flips=torch.rand((b, dim), generator=generator, device=device) < 0.5,
        noise_var=uniform(*cfg.noise_var),
        noise=torch.randn((b, *out_shape, channels), generator=generator, device=device),
        do_noise=trigger(cfg.p_noise),
        blur_sigma=uniform(*cfg.blur_sigma), do_blur=trigger(cfg.p_blur),
        brightness=uniform(*cfg.brightness_range), do_brightness=trigger(cfg.p_brightness),
        contrast=uniform(*cfg.contrast_range), do_contrast=trigger(cfg.p_contrast),
        zoom=uniform(*cfg.lowres_zoom), do_lowres=trigger(cfg.p_lowres),
        gamma=uniform(*cfg.gamma_range), gamma_invert=trigger(cfg.p_gamma_invert),
        do_gamma=trigger(cfg.p_gamma),
        elastic_alpha=uniform(*cfg.elastic_alpha), elastic_sigma=uniform(*cfg.elastic_sigma),
        do_elastic=trigger(cfg.p_elastic),
    )
    if cfg.p_elastic > 0:
        draws["elastic_noise"] = uniform(-1.0, 1.0, (dim, *elastic_lattice_shape(out_shape)))
    return AugmentParams(**draws)


# ------------------------------------------------------------ transform
def _rotation_matrix_3d(angles: torch.Tensor) -> torch.Tensor:
    """``rz @ ry @ rx`` of ``angles [B, 3]`` (about axes 0, 1, 2), float32,
    evaluated in float64 in closed form: the same bits on every device."""
    a = angles.double()
    cx, sx = torch.cos(a[:, 0]), torch.sin(a[:, 0])
    cy, sy = torch.cos(a[:, 1]), torch.sin(a[:, 1])
    cz, sz = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2).float()


def _affine_matrix(params: AugmentParams, cfg: AugmentConfig, dim: int) -> torch.Tensor:
    """``rot @ diag(scale)`` per sample, ``[B, dim, dim]``: the drawn angles
    and scale where their triggers fired, else 0 and 1. In dummy-2D mode
    only the rotation about axis 0 and the in-plane scale act."""
    angles = torch.where(params.do_rotation[:, None], params.angles, 0.0)
    scale = torch.where(params.do_scale, params.scale, 1.0)
    if cfg.dummy_2d:
        angles = angles * angles.new_tensor([1.0, 0.0, 0.0])
        scale_vec = torch.stack([torch.ones_like(scale), scale, scale], -1)
    else:
        scale_vec = scale[:, None].expand(-1, 3)
    if dim == 3:
        rot = _rotation_matrix_3d(angles)
    else:
        zeros = torch.zeros_like(angles[:, 2])
        rot = _rotation_matrix_3d(torch.stack([zeros, zeros, angles[:, 2]], -1))[:, :2, :2]
    # the product with a diagonal matrix: each column scaled, one rounding
    return rot * scale_vec[:, None, :dim]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (through float64)."""
    return (a.double() * b.double() + c.double()).float()


def _affine_coords(mat: torch.Tensor, in_shape: Sequence[int],
                   out_shape: Sequence[int]) -> torch.Tensor:
    """Sample coordinates ``[B, dim, *out_shape]`` in the input patch:
    ``mat [B, dim, dim]`` applied about the centres of both patches."""
    dim = len(out_shape)
    b = mat.shape[0]
    dev = mat.device
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev) for s in out_shape],
                           indexing="ij")
    centred = [g - (s - 1) / 2.0 for g, s in zip(grids, out_shape)]
    view = (b,) + (1,) * dim
    coords = []
    for i in range(dim):
        # summed as XLA's float32 dot sums it: the first product, then one
        # fused multiply-add per term
        acc = mat[:, i, 0].view(view) * centred[0]
        for k in range(1, dim):
            acc = _fma(mat[:, i, k].view(view), centred[k], acc)
        coords.append(acc + (in_shape[i] - 1) / 2.0)
    return torch.stack(coords, 1)


def _gaussian_blur_1d(x: torch.Tensor, sigma: torch.Tensor, axis: int,
                      ksize: int = 7) -> torch.Tensor:
    """Gaussian blur along ``axis`` of ``x [B, ...]`` with one ``sigma`` per
    sample (floored at 1e-3), zero padding, output the input's size: the
    JAX package's ``SAME`` convolution."""
    offs = torch.arange(ksize, dtype=torch.float32, device=x.device) - (ksize - 1) / 2
    w = torch.exp(-0.5 * (offs / torch.clamp(sigma, min=1e-3)[:, None]) ** 2)
    w = w / w.sum(-1, keepdim=True)
    xm = x.movedim(axis, -1)
    length, half = xm.shape[-1], (ksize - 1) // 2
    padded = F.pad(xm, (half, ksize - 1 - half))
    view = (x.shape[0],) + (1,) * (xm.dim() - 1)
    out = w[:, 0].view(view) * padded[..., :length]
    for k in range(1, ksize):
        out = out + w[:, k].view(view) * padded[..., k:k + length]
    return out.movedim(-1, axis)


def _elastic_field(noise: torch.Tensor, alpha: torch.Tensor, sigma: torch.Tensor,
                   out_shape: Sequence[int], lattice_stride: int = 4) -> torch.Tensor:
    """Smoothed displacement field ``[B, dim, *out_shape]`` from lattice
    noise ``[B, dim, *lattice]``: blurred on the lattice with
    ``sigma / lattice_stride`` (ksize 9), resized linearly to the patch with
    half-pixel centres, times ``alpha``."""
    dim = len(out_shape)
    sig_c = sigma / lattice_stride
    for ax in range(dim):
        noise = _gaussian_blur_1d(noise, sig_c, axis=ax + 2, ksize=9)
    mode = "trilinear" if dim == 3 else "bilinear"
    field = F.interpolate(noise, size=tuple(out_shape), mode=mode, align_corners=False)
    return field * alpha.view((-1,) + (1,) * (dim + 1))


def augment_coords(params: AugmentParams, in_shape: Sequence[int],
                   cfg: AugmentConfig) -> torch.Tensor:
    """The source coordinate of every output voxel, ``[B, dim, *patch]``:
    the affine map, plus the elastic field where it fired, quantised where
    the low-resolution simulation fired."""
    out_shape = tuple(cfg.patch_size)
    dim = len(out_shape)
    coords = _affine_coords(_affine_matrix(params, cfg, dim), in_shape, out_shape)
    if cfg.p_elastic > 0:
        field = _elastic_field(params.elastic_noise, params.elastic_alpha,
                               params.elastic_sigma, out_shape)
        field = field * params.do_elastic.float().view((-1,) + (1,) * (dim + 1))
        if cfg.dummy_2d:
            field = field * field.new_tensor([0.0] + [1.0] * (dim - 1)).view(
                (dim,) + (1,) * dim)
        coords = coords + field
    zoom = params.zoom.view((-1,) + (1,) * (dim + 1))
    coords_q = torch.floor(coords * zoom) / torch.clamp(zoom, min=1e-3)
    return torch.where(params.do_lowres.view(zoom.shape), coords_q, coords)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest integer, halves away from zero (``lax.round``;
    ``torch.round`` rounds halves to even)."""
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x), 0.0)


def _flat_index(idx, shape):
    """Row-major flat index of per-axis indices and whether all lie inside."""
    flat = torch.zeros_like(idx[0])
    valid = torch.ones_like(idx[0], dtype=torch.bool)
    for i, s in zip(idx, shape):
        flat = flat * s + i.clamp(0, s - 1)
        valid &= (i >= 0) & (i < s)
    return flat, valid


def _gather_linear(data: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(order=1, mode="constant", cval=0)`` of each channel
    of ``data [B, *in, C]`` at ``coords [B, dim, *out]``: ``[B, *out, C]`` in
    ``data``'s dtype. Each corner is weighted in float32, in the order
    ``map_coordinates`` takes them (the last axis fastest)."""
    b, in_shape, c = data.shape[0], data.shape[1:-1], data.shape[-1]
    dim = len(in_shape)
    flat_data = data.reshape(b, -1, c)
    lower = torch.floor(coords)
    upper_w = coords - lower
    lower = lower.long()
    nodes = [((lower[:, d], 1 - upper_w[:, d]), (lower[:, d] + 1, upper_w[:, d]))
             for d in range(dim)]
    out = None
    for corner in range(2 ** dim):
        picks = [nodes[d][(corner >> (dim - 1 - d)) & 1] for d in range(dim)]
        flat, valid = _flat_index([p[0] for p in picks], in_shape)
        weight = picks[0][1]
        for p in picks[1:]:
            weight = weight * p[1]
        vals = torch.gather(flat_data, 1, flat.reshape(b, -1, 1).expand(-1, -1, c))
        vals = torch.where(valid.reshape(b, -1, 1), vals, 0).float()
        term = weight.reshape(b, -1, 1) * vals
        out = term if out is None else out + term
    return out.to(data.dtype).reshape(b, *coords.shape[2:], c)


def _gather_nearest(seg: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(order=0, mode="constant", cval=-1)`` of ``seg [B,
    *in]`` at ``coords [B, dim, *out]``: int32 ``[B, *out]``."""
    b, in_shape = seg.shape[0], seg.shape[1:]
    idx = [_round_half_away(coords[:, d]).long() for d in range(len(in_shape))]
    flat, valid = _flat_index(idx, in_shape)
    vals = torch.gather(seg.reshape(b, -1).int(), 1, flat.reshape(b, -1))
    return torch.where(valid.reshape(b, -1), vals, -1).reshape(flat.shape)


def apply_augment(data: torch.Tensor, seg: torch.Tensor, params: AugmentParams,
                  cfg: AugmentConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment ``data [B, *gen_patch, C]`` and ``seg [B, *gen_patch]`` with
    the draws ``params``; crops to ``cfg.patch_size``. Returns float32 data
    ``[B, *patch, C]`` and int32 seg ``[B, *patch]``."""
    out_shape = tuple(cfg.patch_size)
    dim = len(out_shape)
    b = data.shape[0]
    bview = (b,) + (1,) * (dim + 1)

    def per_sample(v):
        return v.view(bview)

    coords = augment_coords(params, seg.shape[1:], cfg)
    data_out = _gather_linear(data, coords)
    seg_out = _gather_nearest(seg, coords)

    for ax in cfg.mirror_axes:
        if ax >= dim:  # 3D default (0, 1, 2) on a 2D patch
            continue
        flip = params.flips[:, ax]
        data_out = torch.where(per_sample(flip), data_out.flip(ax + 1), data_out)
        seg_out = torch.where(flip.view(bview[:-1]), seg_out.flip(ax + 1), seg_out)

    # intensity, on all channels of a sample jointly; float32 from here
    x = data_out.float()
    noise = params.noise * per_sample(torch.sqrt(params.noise_var))
    x = torch.where(per_sample(params.do_noise), x + noise, x)
    blurred = x
    for ax in range(dim):
        blurred = _gaussian_blur_1d(blurred, params.blur_sigma, axis=ax + 1)
    x = torch.where(per_sample(params.do_blur), blurred, x)
    x = torch.where(per_sample(params.do_brightness), x * per_sample(params.brightness), x)
    mean = per_sample(x.reshape(b, -1).mean(1))
    x = torch.where(per_sample(params.do_contrast),
                    (x - mean) * per_sample(params.contrast) + mean, x)
    # gamma with retained statistics (population std, as jnp.std)
    flat = x.reshape(b, -1)
    mn, sd = per_sample(flat.mean(1)), per_sample(flat.std(1, correction=0) + 1e-8)
    lo = per_sample(flat.amin(1))
    rng = per_sample(flat.amax(1)) - lo + 1e-8
    invert = per_sample(params.gamma_invert)
    # clamp into [0, 1]: under invert a ratio above 1 would make the base
    # of the power negative
    xn = torch.clamp((x - lo) / rng, 0.0, 1.0)
    xn = torch.where(invert, 1.0 - xn, xn)
    xg = xn ** per_sample(params.gamma)
    xg = torch.where(invert, 1.0 - xg, xg)
    xg = xg * rng + lo
    g = xg.reshape(b, -1)
    xg = (xg - per_sample(g.mean(1))) / per_sample(g.std(1, correction=0) + 1e-8) * sd + mn
    x = torch.where(per_sample(params.do_gamma), xg, x)

    if cfg.mask_norm_zero:
        x = torch.where((seg_out < 0)[..., None], 0.0, x)
    return x, seg_out


def augment_batch(generator: torch.Generator, data: torch.Tensor, seg: torch.Tensor,
                  cfg: AugmentConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_augment_params` from ``generator``, then
    :func:`apply_augment`.

    Args:
        data: ``[B, *gen_patch, C]``; seg: ``[B, *gen_patch]``
    Returns:
        ``(data [B, *patch, C] float32, seg [B, *patch] int32)``
    """
    params = sample_augment_params(cfg, data.shape[0], data.shape[-1], generator, data.device)
    return apply_augment(data, seg, params, cfg)


def center_crop_batch(data: torch.Tensor, seg: torch.Tensor,
                      patch_size: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """No-augmentation validation path: centre crop to the final patch."""
    in_shape = seg.shape[1:]
    starts = [(i - p) // 2 for i, p in zip(in_shape, patch_size)]
    sl = (slice(None),) + tuple(slice(s, s + p) for s, p in zip(starts, patch_size))
    return data[sl + (slice(None),)], seg[sl]
