"""Plain detection head of the Retina U-Net: the anchors, the train-step
losses (ATSS matching, hard-negative sampling, BCE, GIoU, segmentation CE
and dice) and the tile post-processing (decode, clip, top-k, small boxes,
class-batched greedy NMS), in float32, for one configuration dictionary.

The losses follow ``train_step_loss`` of ``nndetection_tpu_torch/models/
retina_unet.py`` and the greedy NMS its plain ``nms_topk_plain``, frozen
here as plain PyTorch; nothing of the program is imported.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import losses as L
from .anchors import AnchorGenerator
from .boxes import box_corners, boxes_from_corners, clip_boxes_to_image, small_boxes_mask
from .coder import BoxCoder
from .matcher import ATSSMatcher, IoUMatcher, gather_matched
from .model import anchors_per_position, cumulative_strides
from .sampler import HardNegativeSamplerBatched


def anchors(cfg: dict) -> Tuple[np.ndarray, List[int]]:
    """The anchor grid of the configuration's patch, every decoder level."""
    strides = cumulative_strides(cfg)
    levels = [strides[level] for level in cfg["decoder_levels"]]
    shapes = [tuple(-(-p // s) for p, s in zip(cfg["patch_size"], st)) for st in levels]
    gen = AnchorGenerator(width=cfg["anchor_width"], height=cfg["anchor_height"],
                          depth=cfg["anchor_depth"] if cfg["dim"] == 3 else None)
    grid, per_level = gen.grid_anchors(shapes, levels)
    assert grid.shape[0] == sum(per_level)
    assert per_level[0] % anchors_per_position(cfg) == 0
    return grid, per_level


def train_step_loss(cfg: dict, predictions: Dict[str, torch.Tensor], anchor_grid: torch.Tensor,
                    anchors_per_level: Sequence[int], targets: Dict[str, torch.Tensor],
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """``cls``, ``reg``, ``seg_ce``, ``seg_dice``, ``num_pos``, ``num_neg`` of
    one batch; the sampler draws from ``generator``."""
    box_logits, box_deltas = predictions["box_logits"], predictions["box_deltas"]
    b, a, c = box_logits.shape
    if cfg["matcher_type"] == "atss":
        matcher = ATSSMatcher(num_candidates=cfg["matcher_num_candidates"],
                              center_in_gt=cfg["matcher_center_in_gt"])
    else:
        matcher = IoUMatcher(low_threshold=cfg["matcher_low_threshold"],
                             high_threshold=cfg["matcher_high_threshold"])
    matched = matcher(targets["gt_boxes"], targets["gt_mask"], anchor_grid,
                      tuple(anchors_per_level), anchors_per_position(cfg))
    labels, matched_boxes = gather_matched(matched, targets["gt_boxes"], targets["gt_classes"])

    fg_probs = torch.sigmoid(box_logits.detach().float()).amax(dim=-1)
    sampler = HardNegativeSamplerBatched(
        batch_size_per_image=cfg["batch_size_per_image"],
        positive_fraction=cfg["positive_fraction"], min_neg=cfg["min_neg"],
        pool_size=cfg["pool_size"], batch_size=1)
    pos_mask, neg_mask = sampler(generator, labels, fg_probs)
    sample_mask = pos_mask | neg_mask
    pos_mask, neg_mask, sample_mask = (m.reshape(-1) for m in (pos_mask, neg_mask, sample_mask))
    flat_labels = labels.reshape(-1)

    cls_loss = L.bce_one_hot(box_logits.reshape(-1, c), flat_labels.clamp(min=0), sample_mask,
                             num_classes=cfg["classifier_classes"])
    coder = BoxCoder(dim=cfg["dim"])
    n_coords = anchor_grid.shape[-1]
    flat_anchors = anchor_grid[None].expand(b, a, n_coords).reshape(-1, n_coords)
    reg_loss = L.giou_loss(coder.decode(box_deltas.reshape(-1, n_coords), flat_anchors),
                           matched_boxes.reshape(-1, n_coords), pos_mask)

    seg_target = (targets["seg"] > 0).long()
    seg_logits = predictions["seg_logits"]
    seg_ce = cfg["segmenter_alpha"] * L.softmax_ce_loss(seg_logits, seg_target)
    seg_dice = (1 - cfg["segmenter_alpha"]) * L.soft_dice_loss(
        seg_logits, seg_target, batch_dice=cfg["batch_dice"], do_bg=False)
    return {"cls": cls_loss, "reg": reg_loss, "seg_ce": seg_ce, "seg_dice": seg_dice,
            "num_pos": pos_mask.float().sum(), "num_neg": neg_mask.float().sum()}


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of each image: ``boxes [I, N, 2*dim]``, ``scores [I, N]``
    (``-inf`` invalid) -> ``(idx [I, max_out], valid [I, max_out])``; the
    highest score first, equal scores by the lower index."""
    n_img = scores.shape[0]
    s = scores.clone()
    mins, maxs = box_corners(boxes)
    vol = (maxs - mins).prod(dim=-1)
    rows = torch.arange(n_img, device=boxes.device)
    idx = torch.zeros((n_img, max_out), dtype=torch.int64, device=boxes.device)
    valid = torch.zeros((n_img, max_out), dtype=torch.bool, device=boxes.device)
    for step in range(max_out):
        k = torch.argmax(s, dim=1)
        alive = s[rows, k] > float("-inf")
        inter = (torch.minimum(maxs[rows, k][:, None], maxs)
                 - torch.maximum(mins[rows, k][:, None], mins)).clamp(min=0).prod(dim=-1)
        union = torch.clamp(vol[rows, k][:, None] + vol - inter, min=1e-12)
        drop = inter / union > iou_threshold
        drop[rows, k] = True
        s = torch.where(alive[:, None] & drop, float("-inf"), s)
        idx[:, step] = torch.where(alive, k, 0)
        valid[:, step] = alive
    return idx, valid


def offset_by_label(boxes: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Boxes of label ``l`` moved by ``l * (max coordinate + 1)``, so that
    boxes of different labels never overlap."""
    max_coord = torch.where(valid[..., None], boxes, 0.0).flatten(-2).max(dim=-1).values
    off = labels.float() * (max_coord[..., None] + 1.0)
    mins, maxs = box_corners(boxes)
    return boxes_from_corners(mins + off[..., None], maxs + off[..., None])


def postprocess(cfg: dict, box_logits: torch.Tensor, box_deltas: torch.Tensor,
                anchor_grid: torch.Tensor, topk: int, max_out: int) -> Dict[str, torch.Tensor]:
    """Detections of a batch of tiles: ``boxes [B, M, 2*dim]``, ``scores``,
    ``labels``, ``valid [B, M]`` with ``M = max_out``, best first."""
    probs = torch.sigmoid(box_logits.float())
    b, a, c = probs.shape
    topk = min(topk, a * c)
    boxes = BoxCoder(dim=cfg["dim"]).decode(box_deltas.float(), anchor_grid)
    boxes = clip_boxes_to_image(boxes, cfg["patch_size"])
    top_probs, top_idx = torch.sort(probs.reshape(b, -1), dim=1, descending=True, stable=True)
    top_probs, top_idx = top_probs[:, :topk], top_idx[:, :topk]
    top_labels = top_idx % c
    top_boxes = torch.gather(boxes, 1, (top_idx // c)[..., None].expand(-1, -1, boxes.shape[-1]))
    valid = top_probs > cfg["score_thresh"]
    if cfg["remove_small_boxes"] is not None:
        valid = valid & small_boxes_mask(top_boxes, cfg["remove_small_boxes"])
    masked = torch.where(valid, top_probs, float("-inf"))
    keep, keep_valid = nms_topk(offset_by_label(top_boxes, top_labels, valid), masked,
                                cfg["nms_thresh"], max_out)
    gather = lambda t: torch.gather(t, 1, keep)  # noqa: E731
    return {"boxes": torch.gather(top_boxes, 1, keep[..., None].expand(-1, -1, boxes.shape[-1])),
            "scores": gather(top_probs), "labels": gather(top_labels), "valid": keep_valid}
