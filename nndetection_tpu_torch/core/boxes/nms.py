"""Greedy NMS (counterpart of :mod:`nndetection_tpu.core.boxes.nms`).

Greedy NMS truncated to ``max_out`` survivors is ``max_out`` steps of
(arg-max, suppress by IoU): identical to full greedy NMS followed by
``keep[:max_out]``. :func:`topk_nms` and :func:`batched_nms_topk` run the
steps in the kernel of :mod:`nndetection_tpu_torch.ops.nms`, one launch for
all images, 2D boxes too: the kernel's wrapper lifts them to unit depth,
after the label offset, which so never moves z.

:func:`nms_mask` and :func:`batched_nms_mask` are the untruncated greedy NMS
of one image, returning a keep mask: the suppression relation of the
score-sorted boxes and the keep-scan over it run in the kernels of
:mod:`nndetection_tpu_torch.ops.suppression`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nndetection_tpu_torch.core.boxes.ops import box_corners, boxes_from_corners
from nndetection_tpu_torch.ops.nms import nms_topk
from nndetection_tpu_torch.ops.suppression import nms_keep_scan, suppression_matrix


def topk_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS keeping at most ``max_out`` boxes per image.

    Args:
        boxes: ``[I, N, 2*dim]``
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


def _offset_by_label(boxes: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The coordinate-offset trick: boxes of label ``l`` move by
    ``l * (max coordinate + 1)`` along every axis, per image (``[..., N, 2*dim]``),
    so that boxes of different labels never overlap."""
    boxes = boxes.float()
    masked_coords = torch.where(valid[..., None], boxes, 0.0)
    max_coord = masked_coords.flatten(-2).max(dim=-1).values
    offsets = labels.float() * (max_coord[..., None] + 1.0)
    mins, maxs = box_corners(boxes)
    return boxes_from_corners(mins + offsets[..., None], maxs + offsets[..., None])


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
    return topk_nms(_offset_by_label(boxes, labels, valid), scores, valid, iou_threshold, max_out)


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Untruncated greedy NMS of one image, returning a keep mask ``[N]``
    (``boxes [N, 2*dim]``, ``scores [N]``, ``valid [N]``). Boxes are ranked by
    score, ties by index; the mask stays on the device of the inputs."""
    n = boxes.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=boxes.device)
    masked = torch.where(valid, scores.float(), float("-inf"))
    order = torch.sort(masked, descending=True, stable=True).indices
    valid_sorted = torch.isfinite(masked[order])
    keep_sorted = nms_keep_scan(suppression_matrix(boxes.float()[order], iou_threshold),
                                valid_sorted)
    return torch.zeros(n, dtype=torch.bool, device=boxes.device).index_put_((order,), keep_sorted)


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Class-batched :func:`nms_mask` via the coordinate-offset trick."""
    if boxes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=boxes.device)
    return nms_mask(_offset_by_label(boxes, labels, valid), scores, valid, iou_threshold)


def weighted_nms_topk(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    weights: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS of one image ranking by ``scores * weights`` (the model-level
    "weighted NMS" of ensembling): ``boxes [N, 2*dim]``, ``scores``, ``weights``,
    ``valid [N]`` -> ``(keep_idx [max_out], keep_valid [max_out])``."""
    idx, keep = topk_nms(boxes[None], (scores * weights)[None], valid[None], iou_threshold, max_out)
    return idx[0], keep[0]
