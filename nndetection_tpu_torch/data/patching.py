"""Sliding-window tiling and safe crop extraction (copy of the host
functions of :mod:`nndetection_tpu.data.patching`).

The grid is plain index arithmetic on the host: tile origins as an
``[T, dim]`` int array, every tile of one fixed patch size.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def compute_grid(
    case_shape: Sequence[int],
    patch_size: Sequence[int],
    overlap: float = 0.5,
    mode: str = "symmetric",
) -> np.ndarray:
    """Tile origins covering ``case_shape`` with fixed-size patches.

    ``symmetric`` mode distributes the leftover border evenly; origins are
    clipped so every tile lies inside the case. Assumes
    ``case_shape >= patch_size`` per axis (pad the case first otherwise).

    Returns:
        ``[T, dim]`` int64 array of tile origins.
    """
    per_axis: List[np.ndarray] = []
    for size, patch in zip(case_shape, patch_size):
        patch = min(patch, size)
        step = max(1, int(round(patch * (1.0 - overlap))))
        if size == patch:
            starts = np.asarray([0])
        else:
            n = int(np.ceil((size - patch) / step)) + 1
            if mode == "symmetric":
                starts = np.round(np.linspace(0, size - patch, n)).astype(np.int64)
            else:  # "fixed"
                starts = np.arange(n) * step
                starts = np.clip(starts, 0, size - patch)
            starts = np.unique(starts)
        per_axis.append(starts.astype(np.int64))
    grids = np.meshgrid(*per_axis, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def pad_to_min_shape(
    data: np.ndarray, min_shape: Sequence[int], spatial_offset: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetrically pad spatial axes up to ``min_shape``.

    Returns padded data and the per-axis lower padding (origin offset of the
    original volume inside the padded one).
    """
    spatial = data.shape[spatial_offset:]
    pads = [(0, 0)] * spatial_offset
    lower = []
    for s, m in zip(spatial, min_shape):
        total = max(0, m - s)
        lo = total // 2
        pads.append((lo, total - lo))
        lower.append(lo)
    if any(p != (0, 0) for p in pads):
        data = np.pad(data, pads, mode="constant")
    return data, np.asarray(lower, dtype=np.int64)


def extract_tile(
    data: np.ndarray,
    origin: Sequence[int],
    patch_size: Sequence[int],
    spatial_offset: int = 1,
) -> np.ndarray:
    """Slice a fixed-size tile at ``origin`` (origins must be in-bounds)."""
    sl = [slice(None)] * spatial_offset
    for o, p in zip(origin, patch_size):
        sl.append(slice(int(o), int(o) + int(p)))
    return data[tuple(sl)]


def save_get_crop(
    data: np.ndarray,
    origin: Sequence[int],
    patch_size: Sequence[int],
    spatial_offset: int = 1,
    mode: str = "shift",
) -> Tuple[np.ndarray, np.ndarray]:
    """Safe crop extraction (``patching.py:304-457``).

    ``shift`` mode moves the origin into bounds; ``pad`` mode zero-pads out-of-
    bounds regions, so that its crop is ``patch_size`` even wholly outside
    the volume (where the JAX package's slices with a negative end). Returns
    the crop and its effective origin in case coords.
    """
    spatial = data.shape[spatial_offset:]
    origin = np.asarray(origin, dtype=np.int64)
    patch = np.asarray(patch_size, dtype=np.int64)
    if mode == "shift":
        shifted = np.clip(origin, 0, np.maximum(0, np.asarray(spatial) - patch))
        return extract_tile(data, shifted, patch, spatial_offset), shifted
    # pad mode: the part inside the volume (empty when there is none), then
    # zeros up to the patch on either side
    lo = np.clip(origin, 0, spatial)
    hi = np.maximum(np.clip(origin + patch, 0, spatial), lo)
    sl = [slice(None)] * spatial_offset + [
        slice(int(a), int(b)) for a, b in zip(lo, hi)
    ]
    crop = data[tuple(sl)]
    pad_lo = np.clip(lo - origin, 0, patch)
    pad_hi = patch - pad_lo - (hi - lo)
    pads = [(0, 0)] * spatial_offset + [(int(a), int(b)) for a, b in zip(pad_lo, pad_hi)]
    return np.pad(crop, pads, mode="constant"), origin


def tile_weight_map(
    patch_size: Sequence[int], mode: str = "gaussian", sigma_scale: float = 1 / 8
) -> np.ndarray:
    """Per-voxel tile weighting to down-weight borders when stitching
    (Gaussian importance map)."""
    if mode == "constant":
        return np.ones(tuple(patch_size), dtype=np.float32)
    grids = np.meshgrid(
        *[np.arange(p, dtype=np.float64) for p in patch_size], indexing="ij"
    )
    w = np.ones(tuple(patch_size), dtype=np.float64)
    for g, p in zip(grids, patch_size):
        center = (p - 1) / 2.0
        sigma = max(p * sigma_scale, 1e-8)
        w *= np.exp(-0.5 * ((g - center) / sigma) ** 2)
    w /= w.max()
    w[w == 0] = w[w > 0].min()
    return w.astype(np.float32)
