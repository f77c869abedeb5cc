"""Synthetic LUNA16-statistics thoracic-CT proxy dataset generator.

The port's copy of :mod:`nndetection_tpu.data.luna_proxy`: the same names,
signatures and outputs, with its imports pointed at the port.

Real LUNA16 is unavailable in this environment (no data on disk, zero
network egress), so this generates the closest on-disk stand-in with the
statistics that matter for the detection pipeline, in the *actual LUNA16
layout* (``subset0..subset9/*.mhd`` + ``annotations.csv``) so the real
``projects/Task016_Luna/prepare.py`` converter, world-coordinate CPM
exporter, and official-style FROC scoring all run unmodified:

- anisotropic spacings: in-plane 0.7-1.0 mm, z 1.25-2.5 mm;
- CT-like HU intensities: air -1000, lung parenchyma ~-860 with noise,
  soft-tissue body, vessels (bright cylinders inside the lung — the
  dominant false-positive source in real CT), calcifications;
- 0-3 lung nodules per case, lobulated (union of jittered spheres), some
  vessel-attached, log-normal diameter distribution clipped to 3.5-28 mm
  (LUNA16's 3-30 mm range, most mass at 4-10 mm);
- world-coordinate annotations (center x/y/z + diameter) exactly like
  ``annotations.csv`` in the official release.

Reference statistics being imitated: nnDetection's ``projects/Task016_Luna``
(annotation format) and the published dataset description (888 scans, ~1.1
annotated nodules/scan; here scaled to an on-disk-feasible case count).
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from nndetection_tpu_torch.data import mhd


def _coarse_noise(rng, shape, scale: int, amplitude: float) -> np.ndarray:
    """Cheap smooth-ish noise: coarse grid upsampled by repetition."""
    coarse = [max(1, s // scale) for s in shape]
    g = rng.standard_normal(coarse).astype(np.float32) * amplitude
    for ax, (c, s) in enumerate(zip(coarse, shape)):
        reps = -(-s // c)
        g = np.repeat(g, reps, axis=ax)
    return g[tuple(slice(0, s) for s in shape)]


def _ellipsoid_mask(shape, center_mm, radii_mm, spacing) -> np.ndarray:
    grids = [
        (np.arange(s, dtype=np.float32) * sp - c) / r
        for s, sp, c, r in zip(shape, spacing, center_mm, radii_mm)
    ]
    zz = grids[0][:, None, None] ** 2
    yy = grids[1][None, :, None] ** 2
    xx = grids[2][None, None, :] ** 2
    return zz + yy + xx <= 1.0


def _paint_sphere(vol, center_mm, radius_mm, spacing, value, noise_rng=None):
    """Set voxels within ``radius_mm`` of ``center_mm`` to ``value`` (+noise);
    returns the painted boolean mask restricted to its bbox (mask, slices)."""
    lo = [
        max(0, int((c - radius_mm) / sp) - 1)
        for c, sp in zip(center_mm, spacing)
    ]
    hi = [
        min(s, int((c + radius_mm) / sp) + 2)
        for c, sp, s in zip(center_mm, spacing, vol.shape)
    ]
    if any(h <= l for l, h in zip(lo, hi)):
        return None, None
    sl = tuple(slice(l, h) for l, h in zip(lo, hi))
    grids = [
        np.arange(l, h, dtype=np.float32) * sp - c
        for l, h, sp, c in zip(lo, hi, spacing, center_mm)
    ]
    d2 = (
        grids[0][:, None, None] ** 2
        + grids[1][None, :, None] ** 2
        + grids[2][None, None, :] ** 2
    )
    mask = d2 <= radius_mm**2
    region = vol[sl]
    vals = np.full(mask.sum(), value, np.float32)
    if noise_rng is not None:
        vals += noise_rng.standard_normal(vals.shape).astype(np.float32) * 20.0
    region[mask] = vals
    vol[sl] = region
    return mask, sl


def _paint_segment(vol, p0_mm, p1_mm, radius_mm, spacing, value):
    """Paint a cylinder (distance-to-segment) — a vessel."""
    lo = [
        max(0, int((min(a, b) - radius_mm) / sp) - 1)
        for a, b, sp in zip(p0_mm, p1_mm, spacing)
    ]
    hi = [
        min(s, int((max(a, b) + radius_mm) / sp) + 2)
        for a, b, sp, s in zip(p0_mm, p1_mm, spacing, vol.shape)
    ]
    if any(h <= l for l, h in zip(lo, hi)):
        return
    sl = tuple(slice(l, h) for l, h in zip(lo, hi))
    grids = np.meshgrid(
        *[
            np.arange(l, h, dtype=np.float32) * sp
            for l, h, sp in zip(lo, hi, spacing)
        ],
        indexing="ij",
    )
    p0 = np.asarray(p0_mm, np.float32)
    seg = np.asarray(p1_mm, np.float32) - p0
    seg_len2 = float(seg @ seg) + 1e-6
    rel = [g - c for g, c in zip(grids, p0)]
    t = sum(r * s for r, s in zip(rel, seg)) / seg_len2
    t = np.clip(t, 0.0, 1.0)
    d2 = sum((r - t * s) ** 2 for r, s in zip(rel, seg))
    mask = d2 <= radius_mm**2
    region = vol[sl]
    region[mask] = value
    vol[sl] = region


def generate_proxy_case(
    rng: np.random.RandomState,
    inplane: int = 256,
    nodule_count_probs: Sequence[float] = (0.25, 0.40, 0.25, 0.10),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[Tuple[float, float, float, float]]]:
    """One synthetic thoracic case.

    Returns ``(volume_int16 [k,j,i], spacing_kji, origin_xyz,
    annotations [(world_x, world_y, world_z, diameter_mm), ...])``.
    """
    sp_xy = rng.uniform(0.7, 1.0)
    sp_z = rng.uniform(1.25, 2.5)
    spacing = np.asarray([sp_z, sp_xy, sp_xy], np.float32)
    extent_z_mm = rng.uniform(200.0, 260.0)
    nz = int(round(extent_z_mm / sp_z))
    shape = (nz, inplane, inplane)
    fov_mm = inplane * sp_xy
    origin_xyz = rng.uniform(-250.0, -150.0, size=3)

    vol = np.full(shape, -1000.0, np.float32)

    # body: soft-tissue ellipse cylinder (chest oval)
    cy, cx = fov_mm * 0.5, fov_mm * 0.5
    ry, rx = fov_mm * 0.36, fov_mm * 0.44
    yy = ((np.arange(inplane, dtype=np.float32) * sp_xy - cy) / ry) ** 2
    xx = ((np.arange(inplane, dtype=np.float32) * sp_xy - cx) / rx) ** 2
    body2d = yy[:, None] + xx[None, :] <= 1.0
    body_vals = 30.0 + _coarse_noise(rng, shape, 8, 15.0)
    vol[:, body2d] = np.broadcast_to(body_vals, shape)[:, body2d]

    # lungs: two ellipsoids
    z_mid = nz * sp_z * 0.5
    lung_radii = np.asarray([nz * sp_z * 0.42, ry * 0.62, rx * 0.34])
    lung_centers = [
        np.asarray([z_mid, cy, cx - rx * 0.46]),
        np.asarray([z_mid, cy, cx + rx * 0.46]),
    ]
    lung_vals = -860.0 + _coarse_noise(rng, shape, 4, 40.0)
    lung_masks = []
    for lc in lung_centers:
        m = _ellipsoid_mask(shape, lc, lung_radii, spacing)
        vol[m] = lung_vals[m]
        lung_masks.append(m)

    def sample_in_lung(margin: float) -> np.ndarray:
        """Random point (mm, kji) inside a lung ellipsoid scaled by margin."""
        lc = lung_centers[rng.randint(2)]
        while True:
            u = rng.uniform(-1, 1, size=3)
            if float(u @ u) <= 1.0:
                return lc + u * lung_radii * margin

    # vessels: the dominant FP source in chest CT
    vessel_points = []
    for _ in range(rng.randint(50, 90)):
        p0 = sample_in_lung(0.9)
        direction = rng.standard_normal(3)
        direction /= np.linalg.norm(direction) + 1e-6
        length = rng.uniform(15.0, 55.0)
        p1 = p0 + direction * length
        radius = rng.uniform(0.6, 2.2)
        _paint_segment(vol, p0, p1, radius, spacing, rng.uniform(-120.0, 20.0))
        vessel_points.append((p0 + p1) / 2)

    # calcifications / sub-3mm distractors (unannotated)
    for _ in range(rng.randint(0, 4)):
        _paint_sphere(vol, sample_in_lung(0.85), rng.uniform(0.8, 1.4), spacing,
                      rng.uniform(150.0, 500.0))

    # nodules
    n_nodules = int(rng.choice(len(nodule_count_probs), p=nodule_count_probs))
    annotations = []
    for _ in range(n_nodules):
        diam = float(np.clip(np.exp(rng.normal(np.log(7.5), 0.45)), 3.5, 28.0))
        r = diam / 2.0
        if rng.rand() < 0.3 and vessel_points:
            base = vessel_points[rng.randint(len(vessel_points))]
            center = np.asarray(base, np.float64)
        else:
            center = sample_in_lung(0.75)
        center = np.clip(
            center,
            r + spacing,
            np.asarray(shape) * spacing - r - spacing,
        )
        hu = rng.uniform(-40.0, 40.0)
        # lobulated: union of jittered spheres around the center
        painted = _paint_sphere(vol, center, r * 0.82, spacing, hu, rng)
        for _ in range(rng.randint(2, 5)):
            off = rng.uniform(-0.35, 0.35, size=3) * r
            _paint_sphere(vol, center + off, r * rng.uniform(0.5, 0.75),
                          spacing, hu, rng)
        if painted[0] is None:
            continue
        # world coords: center (z,y,x mm) -> (x,y,z) + origin
        world = center[::-1] + origin_xyz
        annotations.append((float(world[0]), float(world[1]), float(world[2]),
                            diam))

    vol = np.clip(vol, -1024, 3071).astype(np.int16)
    return vol, spacing.astype(np.float64), origin_xyz, annotations


def generate_luna_proxy(
    dest,
    num_cases: int = 125,
    seed: int = 0,
    inplane: int = 256,
    num_subsets: int = 10,
) -> Path:
    """Write a full LUNA16-layout proxy dataset: ``subsetK/*.mhd`` (zraw
    compressed) + ``annotations.csv``."""
    dest = Path(dest)
    rows = []
    for idx in range(num_cases):
        rng = np.random.RandomState(seed * 100003 + idx)
        vol, spacing, origin, anns = generate_proxy_case(rng, inplane=inplane)
        cid = f"proxy_{idx:04d}"
        subset_dir = dest / f"subset{idx % num_subsets}"
        subset_dir.mkdir(parents=True, exist_ok=True)
        mhd.save(subset_dir / f"{cid}.mhd", vol, spacing, origin)
        for x, y, z, d in anns:
            rows.append([cid, x, y, z, d])
    with open(dest / "annotations.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["seriesuid", "coordX", "coordY", "coordZ", "diameter_mm"])
        w.writerows(rows)
    return dest
