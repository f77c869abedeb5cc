"""Box geometry primitives on torch tensors (counterpart of
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


def box_corners(boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split interleaved boxes into (mins, maxs), each ``[..., dim]``."""
    c = boxes.shape[-1]
    return boxes[..., list(_MIN_IDX[c])], boxes[..., list(_MAX_IDX[c])]


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


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Pairwise IoU matrix ``[..., N, M]`` (float32)."""
    mins1, maxs1 = box_corners(boxes1.float())
    mins2, maxs2 = box_corners(boxes2.float())
    lo = torch.maximum(mins1[..., :, None, :], mins2[..., None, :, :])
    hi = torch.minimum(maxs1[..., :, None, :], maxs2[..., None, :, :])
    inter = torch.prod((hi - lo).clamp(min=0.0), dim=-1) + eps
    area1 = torch.prod(maxs1 - mins1, dim=-1)
    area2 = torch.prod(maxs2 - mins2, dim=-1)
    union = area1[..., :, None] + area2[..., None, :] - inter + eps
    return inter / union


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
