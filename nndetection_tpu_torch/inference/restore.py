"""Restore predictions from preprocessed to original image geometry (copy of
:mod:`nndetection_tpu.inference.restore`): inverse transpose, spacing rescale
and crop-offset shift for boxes; inverse transpose, resample and uncrop for
label maps."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from nndetection_tpu_torch.core.boxes.ops_np import box_axis_vector_np, permute_boxes_np
from nndetection_tpu_torch.data.resample import resample_seg


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


def restore_fmap(
    seg: np.ndarray,
    transpose_forward: Sequence[int],
    original_shape_cropped: Sequence[int],
    original_shape: Sequence[int],
    crop_bbox: Optional[Sequence[Sequence[int]]] = None,
) -> np.ndarray:
    """Restore a label map to the original image grid: inverse transpose ->
    resample to the cropped shape -> paste into the full-size volume."""
    seg = np.transpose(seg, invert_transpose(transpose_forward))
    seg = resample_seg(seg, original_shape_cropped)
    if crop_bbox is None:
        return seg
    out = np.zeros(tuple(original_shape), dtype=seg.dtype)
    sl = tuple(slice(int(c[0]), int(c[0]) + s) for c, s in zip(crop_bbox, seg.shape))
    out[sl] = seg
    return out
