"""NumPy box ops for host-side code (copy of
:mod:`nndetection_tpu.core.boxes.ops_np`; same interleaved corner format as
:mod:`nndetection_tpu_torch.core.boxes.ops`)."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from nndetection_tpu_torch.ops.native import nms_native

_MIN_IDX = {4: (0, 1), 6: (0, 1, 4)}
_MAX_IDX = {4: (2, 3), 6: (2, 3, 5)}


def box_corners_np(boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    c = boxes.shape[-1]
    return boxes[..., list(_MIN_IDX[c])], boxes[..., list(_MAX_IDX[c])]


def boxes_from_corners_np(mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
    if mins.shape[-1] == 2:
        return np.stack([mins[..., 0], mins[..., 1], maxs[..., 0], maxs[..., 1]], -1)
    return np.stack(
        [mins[..., 0], mins[..., 1], maxs[..., 0], maxs[..., 1],
         mins[..., 2], maxs[..., 2]], -1)


def box_size_np(boxes: np.ndarray) -> np.ndarray:
    mins, maxs = box_corners_np(boxes)
    return maxs - mins


def box_area_np(boxes: np.ndarray) -> np.ndarray:
    return np.prod(box_size_np(boxes).astype(np.float64), axis=-1)


def box_center_np(boxes: np.ndarray) -> np.ndarray:
    mins, maxs = box_corners_np(boxes)
    return (mins + maxs) * 0.5


def box_iou_np(boxes1: np.ndarray, boxes2: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """Pairwise IoU matrix [N, M] in float64 for eval-grade precision."""
    b1 = boxes1.astype(np.float64).reshape(-1, boxes1.shape[-1])
    b2 = boxes2.astype(np.float64).reshape(-1, boxes2.shape[-1])
    mins1, maxs1 = box_corners_np(b1)
    mins2, maxs2 = box_corners_np(b2)
    lo = np.maximum(mins1[:, None, :], mins2[None, :, :])
    hi = np.minimum(maxs1[:, None, :], maxs2[None, :, :])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=-1) + eps
    area1 = np.prod(maxs1 - mins1, axis=-1)
    area2 = np.prod(maxs2 - mins2, axis=-1)
    union = area1[:, None] + area2[None, :] - inter + eps
    return inter / union


def clip_boxes_to_image_np(boxes: np.ndarray, image_shape: Sequence[int]) -> np.ndarray:
    mins, maxs = box_corners_np(boxes)
    bounds = np.asarray(image_shape, dtype=boxes.dtype)
    return boxes_from_corners_np(
        np.clip(mins, 0, bounds), np.clip(maxs, 0, bounds))


def permute_boxes_np(boxes: np.ndarray, dims: Sequence[int]) -> np.ndarray:
    mins, maxs = box_corners_np(boxes)
    dims = list(dims)
    return boxes_from_corners_np(mins[..., dims], maxs[..., dims])


def nms_np(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS; returns kept indices sorted by descending score. 3D boxes
    go to the host library (:func:`nndetection_tpu_torch.ops.native.nms_native`),
    which keeps the same indices as :func:`nms_np_plain`; without a C++
    compiler, and for 2D boxes, :func:`nms_np_plain` runs."""
    if len(boxes) == 0:
        return np.zeros((0,), dtype=np.int64)
    keep = nms_native(boxes, scores, iou_threshold)
    return nms_np_plain(boxes, scores, iou_threshold) if keep is None else keep


def nms_np_plain(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """The NumPy greedy NMS: kept indices, descending score, equal scores in
    index order."""
    if len(boxes) == 0:
        return np.zeros((0,), dtype=np.int64)
    order = np.argsort(-scores, kind="stable")
    iou = box_iou_np(boxes[order], boxes[order])
    n = len(order)
    suppressed = np.zeros(n, dtype=bool)
    keep = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(order[i])
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, dtype=np.int64)


def batched_nms_np(
    boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray, iou_threshold: float
) -> np.ndarray:
    """Class-batched NMS via the coordinate-offset trick."""
    if len(boxes) == 0:
        return np.zeros((0,), dtype=np.int64)
    max_coord = boxes.max()
    offsets = labels.astype(np.float64) * (max_coord + 1)
    mins, maxs = box_corners_np(boxes.astype(np.float64))
    shifted = boxes_from_corners_np(mins + offsets[:, None], maxs + offsets[:, None])
    return nms_np(shifted, scores, iou_threshold)


def box_axis_vector_np(vec, dim: int) -> np.ndarray:
    """Per-axis vector ``(a0, a1[, a2])`` -> box-layout vector
    ``(a0, a1, a0, a1[, a2, a2])`` matching the ``(x1, y1, x2, y2[, z1, z2])``
    corner convention."""
    out = [vec[0], vec[1], vec[0], vec[1]]
    if dim == 3:
        out += [vec[2], vec[2]]
    return np.asarray(out)
