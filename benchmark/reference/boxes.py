"""Frozen copy, for the benchmark's reference, of the plain PyTorch code in
``nndetection_tpu_torch/core/boxes/ops.py``; it imports nothing of the program.

Box geometry primitives on torch tensors (counterpart of
:mod:`nndetection_tpu.core.boxes.ops`).

Box layout is corner-interleaved, as in the JAX package:

* 2D: ``(x1, y1, x2, y2)``
* 3D: ``(x1, y1, x2, y2, z1, z2)``

where ``x``/``y``/``z`` index spatial axes 0/1/2. Pairwise functions take
``[..., N, 2*dim]`` and ``[..., M, 2*dim]`` and broadcast over leading axes;
IoU math is done in float32. Filters return boolean masks, not compacted
index lists, so shapes stay fixed.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

# corner index layout for the interleaved format
_MIN_IDX = {4: (0, 1), 6: (0, 1, 4)}
_MAX_IDX = {4: (2, 3), 6: (2, 3, 5)}


def box_dim(boxes: torch.Tensor) -> int:
    """Number of spatial dims encoded in the last axis (4 -> 2, 6 -> 3)."""
    return boxes.shape[-1] // 2


def columns(t: torch.Tensor, idx) -> torch.Tensor:
    """``t[..., idx]`` for a short list of columns, stacked from slices: the
    backward of a list index is a sort-based scatter, which costs
    milliseconds on the millions of anchors of a train step."""
    return torch.stack([t[..., i] for i in idx], dim=-1)


def prod_last(t: torch.Tensor) -> torch.Tensor:
    """Product over the short last axis (2 or 3 extents) as plain
    multiplies: the backward of ``torch.prod`` runs a scan."""
    out = t[..., 0]
    for i in range(1, t.shape[-1]):
        out = out * t[..., i]
    return out


def box_corners(boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split interleaved boxes into (mins, maxs), each ``[..., dim]``."""
    c = boxes.shape[-1]
    return columns(boxes, _MIN_IDX[c]), columns(boxes, _MAX_IDX[c])


def boxes_from_corners(mins: torch.Tensor, maxs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`box_corners`."""
    if mins.shape[-1] == 2:
        return torch.stack(
            [mins[..., 0], mins[..., 1], maxs[..., 0], maxs[..., 1]], dim=-1
        )
    return torch.stack(
        [
            mins[..., 0],
            mins[..., 1],
            maxs[..., 0],
            maxs[..., 1],
            mins[..., 2],
            maxs[..., 2],
        ],
        dim=-1,
    )


def box_size(boxes: torch.Tensor) -> torch.Tensor:
    """Per-axis extents ``[..., dim]``."""
    mins, maxs = box_corners(boxes)
    return maxs - mins


def box_center(boxes: torch.Tensor) -> torch.Tensor:
    """Center points ``[..., dim]``."""
    mins, maxs = box_corners(boxes)
    return (mins + maxs) * 0.5


def box_iou_union(
    boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU and union ``[..., N, M]`` (float32)."""
    mins1, maxs1 = box_corners(boxes1.float())
    mins2, maxs2 = box_corners(boxes2.float())
    lo = torch.maximum(mins1[..., :, None, :], mins2[..., None, :, :])
    hi = torch.minimum(maxs1[..., :, None, :], maxs2[..., None, :, :])
    inter = prod_last((hi - lo).clamp(min=0.0)) + eps
    area1 = prod_last(maxs1 - mins1)
    area2 = prod_last(maxs2 - mins2)
    union = area1[..., :, None] + area2[..., None, :] - inter + eps
    return inter / union, union


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Pairwise IoU matrix ``[..., N, M]`` (float32)."""
    return box_iou_union(boxes1, boxes2, eps)[0]


def generalized_box_iou(
    boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 0.0
) -> torch.Tensor:
    """Pairwise generalized IoU ``[..., N, M]`` (Rezatofighi et al.)."""
    iou, union = box_iou_union(boxes1, boxes2, eps)
    mins1, maxs1 = box_corners(boxes1.float())
    mins2, maxs2 = box_corners(boxes2.float())
    lo = torch.minimum(mins1[..., :, None, :], mins2[..., None, :, :])
    hi = torch.maximum(maxs1[..., :, None, :], maxs2[..., None, :, :])
    hull = prod_last((hi - lo).clamp(min=0.0)) + eps
    return iou - (hull - union) / hull


def _elementwise_iou_union(boxes1, boxes2, eps):
    mins1, maxs1 = box_corners(boxes1.float())
    mins2, maxs2 = box_corners(boxes2.float())
    inter = prod_last(
        (torch.minimum(maxs1, maxs2) - torch.maximum(mins1, mins2)).clamp(min=0.0))
    union = prod_last(maxs1 - mins1) + prod_last(maxs2 - mins2) - inter
    return (inter + eps) / (union + eps), union


def elementwise_box_iou(
    boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7
) -> torch.Tensor:
    """IoU of corresponding boxes ``[..., N]``."""
    return _elementwise_iou_union(boxes1, boxes2, eps)[0]


def elementwise_generalized_box_iou(
    boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7
) -> torch.Tensor:
    """GIoU of corresponding boxes ``[..., N]``."""
    iou, union = _elementwise_iou_union(boxes1, boxes2, eps)
    mins1, maxs1 = box_corners(boxes1.float())
    mins2, maxs2 = box_corners(boxes2.float())
    hull = prod_last(
        (torch.maximum(maxs1, maxs2) - torch.minimum(mins1, mins2)).clamp(min=0.0)) + eps
    return iou - (hull - union) / hull


def box_center_dist(
    boxes1: torch.Tensor, boxes2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pairwise Euclidean distance of box centers.

    Returns ``(dists [..., N, M], centers1 [..., N, dim], centers2 [..., M, dim])``.
    """
    c1 = box_center(boxes1.float())
    c2 = box_center(boxes2.float())
    diff = c1[..., :, None, :] - c2[..., None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1)), c1, c2


def center_in_boxes(
    centers: torch.Tensor, boxes: torch.Tensor, eps: float = 0.01
) -> torch.Tensor:
    """True where ``centers[i]`` lies inside ``boxes[i]`` by more than
    ``eps`` on every side (elementwise, ``[..., N]``)."""
    mins, maxs = box_corners(boxes.float())
    return torch.minimum(centers - mins, maxs - centers).amin(dim=-1) > eps


def clip_boxes_to_image(boxes: torch.Tensor, image_shape: Sequence[int]) -> torch.Tensor:
    """Clip box coordinates into ``[0, image_shape[axis]]`` per spatial axis."""
    dim = box_dim(boxes)
    assert len(image_shape) == dim, f"need {dim} sizes, got {image_shape}"
    mins, maxs = box_corners(boxes)
    bounds = torch.as_tensor(image_shape, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    mins = torch.minimum(torch.maximum(mins, zero), bounds)
    maxs = torch.minimum(torch.maximum(maxs, zero), bounds)
    return boxes_from_corners(mins, maxs)


def small_boxes_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True for boxes with every side ``>= min_size``."""
    return torch.all(box_size(boxes) >= min_size, dim=-1)


def stable_topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries along the last axis in descending order,
    equal values in ascending index order: ``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise. Exact, through a stable sort."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
