"""Frozen copy, for the benchmark's reference, of the plain PyTorch code in
``nndetection_tpu_torch/data/instances.py``; it imports nothing of the program.

Instance segmentation -> boxes and semantic segmentation (counterpart
of :mod:`nndetection_tpu.data.instances`): the NumPy versions of the
preprocessing, copied, and the tensor versions of the target preparation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def instances_to_boxes_np(
    seg: np.ndarray, instance_ids: Optional[Sequence[int]] = None
) -> Tuple[np.ndarray, List[int]]:
    """Bounding boxes of the labelled instances of ``seg [*spatial]`` (0
    background, >0 ids).

    Returns ``(boxes [N, 2*dim] float64, ids)``, interleaved corners with
    exclusive upper corners (``hi = max index + 1``).
    """
    if instance_ids is None:
        instance_ids = [int(i) for i in np.unique(seg) if i > 0]
    boxes = []
    kept = []
    for iid in instance_ids:
        idx = np.where(seg == iid)
        if len(idx[0]) == 0:
            continue
        lo = [int(a.min()) for a in idx]
        hi = [int(a.max()) + 1 for a in idx]
        if seg.ndim == 2:
            boxes.append([lo[0], lo[1], hi[0], hi[1]])
        else:
            boxes.append([lo[0], lo[1], hi[0], hi[1], lo[2], hi[2]])
        kept.append(iid)
    if not boxes:
        return np.zeros((0, 2 * seg.ndim), dtype=np.float64), []
    return np.asarray(boxes, dtype=np.float64), kept


def instances_to_segmentation_np(
    seg: np.ndarray, instance_classes: Dict[int, int]
) -> np.ndarray:
    """Map instance ids to semantic classes (classes start at 1, 0 bg)."""
    out = np.zeros_like(seg, dtype=np.int16)
    for iid, cls in instance_classes.items():
        out[seg == iid] = cls + 1
    out[seg == -1] = -1
    return out


def instances_to_boxes(seg: torch.Tensor, max_instances: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounding boxes of the instance ids ``1..max_instances`` of one
    instance segmentation ``seg [*spatial]``.

    Returns ``(boxes [max_instances, 2*dim] float32, present [max_instances]
    bool)``, row ``i`` for id ``i + 1``, interleaved corners with exclusive
    upper corners (``hi = max index + 1``); absent ids get zero boxes.
    """
    dim = seg.ndim
    ids = torch.arange(1, max_instances + 1, device=seg.device)
    mask = seg[None] == ids.view(-1, *([1] * dim))  # [I, *spatial]
    present = mask.flatten(1).any(dim=1)
    los, his = [], []
    for d in range(dim):
        # the instance's extent along axis d: reduce the other axes first
        along = mask.any(dim=tuple(a + 1 for a in range(dim) if a != d))  # [I, size_d]
        coord = torch.arange(seg.shape[d], device=seg.device)
        los.append(torch.where(along, coord, seg.shape[d]).amin(dim=1))
        his.append(torch.where(along, coord, -1).amax(dim=1) + 1)
    order = [los[0], los[1], his[0], his[1]] + ([los[2], his[2]] if dim == 3 else [])
    boxes = torch.stack(order, dim=-1).float()
    return torch.where(present[:, None], boxes, 0.0), present


def instances_to_semantic(seg: torch.Tensor, instance_classes: torch.Tensor) -> torch.Tensor:
    """Instance ids -> semantic classes from 1 (0 background, ids beyond the
    table background, negative ids kept): a lookup in
    ``[0, classes + 1, 0]``. ``instance_classes [max_instances]`` holds the
    class (from 0) of id ``i + 1``."""
    n = instance_classes.shape[0]
    zero = torch.zeros(1, dtype=torch.int64, device=seg.device)
    table = torch.cat([zero, instance_classes.long() + 1, zero])
    out = table[seg.long().clamp(0, n + 1)]
    return torch.where(seg < 0, seg.long(), out)
