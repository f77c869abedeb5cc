"""Restore box predictions from preprocessed to original image geometry
(copy of :func:`nndetection_tpu.inference.restore.restore_detection`):
inverse transpose, spacing rescale and crop-offset shift."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from nndetection_tpu_torch.core.boxes.ops_np import box_axis_vector_np, permute_boxes_np


def invert_transpose(transpose_forward: Sequence[int]) -> list:
    inv = [0] * len(transpose_forward)
    for i, t in enumerate(transpose_forward):
        inv[t] = i
    return inv


def restore_detection(
    boxes: np.ndarray,
    transpose_forward: Sequence[int],
    original_spacing: Sequence[float],
    resampled_spacing: Sequence[float],
    crop_bbox: Optional[Sequence[Sequence[int]]] = None,
) -> np.ndarray:
    """Map boxes from preprocessed (transposed+resampled+cropped) voxel space
    back to the original image voxel space.

    Args:
        boxes: ``[N, 2*dim]`` in preprocessed space
        transpose_forward: axis permutation applied during preprocessing
        original_spacing: spacing of the original (cropped) image, in the
            *untransposed* axis order
        resampled_spacing: target spacing used in preprocessing (transposed
            axis order)
        crop_bbox: per-axis ``[lo, hi]`` of the nonzero crop (untransposed)
    """
    if len(boxes) == 0:
        return boxes
    boxes = np.asarray(boxes, dtype=np.float64)
    tb = invert_transpose(transpose_forward)
    boxes = permute_boxes_np(boxes, tb)
    rs = np.asarray(resampled_spacing, dtype=np.float64)[tb]
    os_ = np.asarray(original_spacing, dtype=np.float64)
    dim = boxes.shape[1] // 2
    boxes = boxes * box_axis_vector_np(rs / os_, dim)[None]
    if crop_bbox is not None:
        lo = np.asarray([c[0] for c in crop_bbox], dtype=np.float64)
        boxes = boxes + box_axis_vector_np(lo, dim)[None]
    return boxes
