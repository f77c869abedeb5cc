"""Greedy NMS truncated to ``max_out`` survivors, batched over images
(counterpart of ``topk_nms`` and ``batched_nms_topk`` of
:mod:`nndetection_tpu.core.boxes.nms`).

Greedy NMS truncated to ``max_out`` survivors is ``max_out`` steps of
(arg-max, suppress by IoU): identical to full greedy NMS followed by
``keep[:max_out]``. The steps run in the kernel of
:mod:`nndetection_tpu_torch.ops.nms`, one launch for all images.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nndetection_tpu_torch.core.boxes.ops import box_corners, boxes_from_corners
from nndetection_tpu_torch.ops.nms import nms_topk


def topk_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS keeping at most ``max_out`` boxes per image.

    Args:
        boxes: ``[I, N, 6]``
        scores: ``[I, N]``
        valid: boolean validity ``[I, N]``
        iou_threshold: suppression threshold (strictly greater suppresses)
        max_out: number of survivors to emit

    Returns:
        ``(keep_idx [I, max_out] int64, keep_valid [I, max_out] bool)`` in
        descending-score order.
    """
    masked = torch.where(valid, scores.float(), float("-inf"))
    return nms_topk(boxes.float().contiguous(), masked.contiguous(), iou_threshold, max_out)


def batched_nms_topk(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-batched greedy NMS per image via the coordinate-offset trick:
    boxes of different labels are moved to disjoint regions, so they never
    suppress each other, and one :func:`topk_nms` covers all classes.

    Shapes as :func:`topk_nms`, with ``labels [I, N]``.
    """
    boxes = boxes.float()
    masked_coords = torch.where(valid[..., None], boxes, 0.0)
    max_coord = masked_coords.flatten(1).max(dim=1).values  # [I]
    offsets = labels.float() * (max_coord[:, None] + 1.0)
    mins, maxs = box_corners(boxes)
    shifted = boxes_from_corners(mins + offsets[..., None], maxs + offsets[..., None])
    return topk_nms(shifted, scores, valid, iou_threshold, max_out)
