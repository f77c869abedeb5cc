"""Network topology planning from spacing and patch size (copy of
:mod:`nndetection_tpu.planning.architecture`).

nnU-Net's ``get_pool_and_conv_props``: pool the axes that are within a
factor 2 of the finest current spacing and still at least
``2 * min_feature_map_size`` voxels, again and again; each stage's conv
kernel is 3 along axes near isotropy and 1 along still-anisotropic axes.
Also the decoder-level rule of nnDetection's ``BoxC002``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def get_pool_and_conv_props(
    spacing: Sequence[float],
    patch_size: Sequence[int],
    min_feature_map_size: int = 4,
    max_num_pool: int = 999,
) -> Tuple[List[List[int]], List[List[int]], List[int], List[int]]:
    """
    Returns:
        pool_kernels: per-transition pooling strides (len = stages - 1)
        conv_kernels: per-stage conv kernels (len = stages)
        patch_must_be_divisible_by: per-axis divisibility requirement
        final_patch_size: patch rounded down(!) to the divisibility
    """
    dim = len(spacing)
    current_spacing = np.asarray(spacing, dtype=np.float64).copy()
    current_size = np.asarray(patch_size, dtype=np.float64).copy()

    pool_kernels: List[List[int]] = []
    conv_kernels: List[List[int]] = []
    # first stage kernel
    conv_kernels.append(
        [3 if sp / current_spacing.min() < 2 else 1 for sp in current_spacing]
    )
    num_pool = 0
    while num_pool < max_num_pool:
        min_sp = current_spacing.min()
        valid = [
            a
            for a in range(dim)
            if (current_spacing[a] / min_sp < 2)
            and (current_size[a] >= 2 * min_feature_map_size)
        ]
        # axes lagging in spacing can still pool if they have lots of voxels
        # (nnU-Net's second criterion): pool axes whose size is at least half
        # the maximum size among valid axes
        if not valid:
            break
        pool = [1] * dim
        for a in valid:
            pool[a] = 2
        if all(p == 1 for p in pool):
            break
        pool_kernels.append(pool)
        current_spacing = current_spacing * np.asarray(pool)
        current_size = np.ceil(current_size / np.asarray(pool))
        conv_kernels.append(
            [3 if sp / current_spacing.min() < 2 else 1 for sp in current_spacing]
        )
        num_pool += 1

    must_divide = np.prod(np.asarray(pool_kernels or [[1] * dim]), axis=0).astype(int)
    final_patch = (
        np.floor(np.asarray(patch_size) / must_divide) * must_divide
    ).astype(int)
    final_patch = np.maximum(final_patch, must_divide)
    return pool_kernels, conv_kernels, must_divide.tolist(), final_patch.tolist()


def plan_decoder_levels(num_resolutions: int, num_levels: int = 4) -> Tuple[int, ...]:
    """Four consecutive decoder levels starting at
    ``min(max(1, n_res - 4), 2)`` (``c002.py:200-204``)."""
    start = min(max(1, num_resolutions - num_levels), 2)
    end = min(start + num_levels, num_resolutions)
    return tuple(range(start, end))


def initial_patch_size(
    target_spacing: Sequence[float],
    median_shape: Sequence[int],
    base_mm: float = 512.0,
) -> List[int]:
    """~``base_mm``^(1/3) isotropic FOV clipped to the median case shape
    (``c002.py:298-341``)."""
    dim = len(target_spacing)
    mm = base_mm ** (1.0 / 3.0) * 10 if dim == 3 else base_mm
    # the reference targets a fixed physical FOV per axis derived from 512mm^3
    vox = np.asarray(
        [mm / sp for sp in target_spacing], dtype=np.float64
    )
    vox = np.minimum(vox, np.asarray(median_shape, dtype=np.float64))
    return [int(max(v, 4)) for v in np.round(vox)]


def shrink_largest_axis(
    patch_size: Sequence[int], must_divide: Sequence[int]
) -> List[int]:
    """Shrink the largest patch axis by one divisibility step
    (``base.py:558-589``)."""
    patch = list(patch_size)
    idx = int(np.argmax(patch))
    step = int(must_divide[idx])
    patch[idx] = max(patch[idx] - step, step)
    return patch
