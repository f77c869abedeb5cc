"""Frozen copy, for the benchmark's reference, of the plain PyTorch code in
``nndetection_tpu_torch/data/gt_prep.py``; it imports nothing of the program.

GT preparation: instance segmentation -> training targets (counterpart of
:mod:`nndetection_tpu.data.gt_prep`): padded GT boxes, classes and validity
masks and the semantic segmentation of a batch.
"""
from __future__ import annotations

from typing import Dict

import torch

from .boxes import box_size
from .instances import instances_to_boxes, instances_to_semantic


def prepare_targets(images: torch.Tensor, seg_instances: torch.Tensor,
                    instance_classes: torch.Tensor,
                    min_box_size: float = 1.0) -> Dict[str, torch.Tensor]:
    """
    Args:
        images: ``[B, *patch, C]``
        seg_instances: ``[B, *patch]`` int instance ids (0 bg, -1 outside)
        instance_classes: ``[B, max_instances]`` class of id ``i + 1`` (from
            0), -1 for absent ids

    Returns the training batch: ``images``, ``gt_boxes [B, G, 2*dim]``,
    ``gt_classes [B, G]``, ``gt_mask [B, G]`` and the semantic ``seg [B,
    *patch]`` (outside-mask voxels become background).
    """
    max_instances = instance_classes.shape[1]
    boxes, classes, valid, semantic = [], [], [], []
    for seg, table in zip(seg_instances, instance_classes):
        b, present = instances_to_boxes(seg, max_instances)
        # instances cut to slivers by the crop are dropped
        sizes_ok = (box_size(b) >= min_box_size).all(dim=-1)
        boxes.append(b)
        classes.append(table.long().clamp(min=0))
        valid.append(present & sizes_ok & (table >= 0))
        semantic.append(instances_to_semantic(seg, table).clamp(min=0))
    return {
        "images": images,
        "gt_boxes": torch.stack(boxes),
        "gt_classes": torch.stack(classes),
        "gt_mask": torch.stack(valid),
        "seg": torch.stack(semantic),
    }
