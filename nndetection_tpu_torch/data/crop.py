"""Crop to the nonzero region, nnU-Net style (copy of
:mod:`nndetection_tpu.data.crop`).

Each raw case (all modalities stacked) is cropped to the bounding box of its
nonzero region; segmentation background outside the nonzero mask is marked
``-1`` so mask-based normalization and the ``RemoveLabelTransform`` semantics
downstream can distinguish "air" from in-body background.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy import ndimage


def nonzero_bbox(mask: np.ndarray) -> Tuple[slice, ...]:
    """Bounding-box slices of the True region (whole array if empty)."""
    if not mask.any():
        return tuple(slice(0, s) for s in mask.shape)
    out = []
    for axis in range(mask.ndim):
        other = tuple(i for i in range(mask.ndim) if i != axis)
        line = mask.any(axis=other)
        idx = np.where(line)[0]
        out.append(slice(int(idx[0]), int(idx[-1]) + 1))
    return tuple(out)


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    """Union of per-modality nonzero regions, binary-filled per slice stack
    (``crop.py``/nnU-Net ``create_nonzero_mask`` semantics)."""
    mask = np.zeros(data.shape[1:], dtype=bool)
    for c in range(data.shape[0]):
        mask |= data[c] != 0
    return ndimage.binary_fill_holes(mask)


def crop_to_nonzero(
    data: np.ndarray, seg: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray], Dict]:
    """
    Args:
        data: ``[C, *spatial]`` stacked modalities
        seg: ``[*spatial]`` instance segmentation or None

    Returns:
        ``(cropped_data, cropped_seg, props)`` with ``props['crop_bbox']`` as
        ``[[lo, hi], ...]`` per axis and original/cropped shapes. ``seg`` has
        out-of-mask background set to ``-1``.
    """
    shape_before = data.shape[1:]
    mask = create_nonzero_mask(data)
    bbox = nonzero_bbox(mask)
    data_c = data[(slice(None),) + bbox].copy()
    mask_c = mask[bbox]

    if seg is not None:
        seg_c = seg[bbox].astype(np.int16, copy=True)
        seg_c[(seg_c == 0) & (~mask_c)] = -1
    else:
        seg_c = (np.where(mask_c, 0, -1)).astype(np.int16)

    props = {
        "crop_bbox": [[int(s.start), int(s.stop)] for s in bbox],
        "shape_before_crop": tuple(int(v) for v in shape_before),
        "shape_after_crop": tuple(int(v) for v in data_c.shape[1:]),
        "size_reduction": float(np.prod(data_c.shape[1:]) / max(np.prod(shape_before), 1)),
    }
    return data_c, seg_c, props
