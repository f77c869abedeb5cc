"""Frozen copy, for the benchmark's reference, of the plain PyTorch code in
``nndetection_tpu_torch/core/boxes/matcher.py``; it imports nothing of the program.

Anchor-to-GT matching with static shapes (counterpart of
:mod:`nndetection_tpu.core.boxes.matcher`).

GT boxes come padded, ``[..., G, 2*dim]`` with a validity mask ``[..., G]``;
the leading axes (the batch) are kept, where the JAX package ``vmap``s one
image at a time. The result is ``matched_idx [..., A]`` with the JAX
package's sentinels: ``>= 0`` the matched GT row, ``-1`` background, ``-2``
between thresholds (ignore).

Candidate selection is exact, with ``jax.lax.top_k``'s tie order (lower
index first). The JAX package uses ``approx_min_k`` on a TPU; on a CPU it is
exact, and in ATSS the ties are systematic: the anchors of one grid position
share a centre, and grid positions equally far from a GT centre are common.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .boxes import (
    box_center_dist,
    box_iou,
    center_in_boxes,
    stable_topk,
)

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2
_NEG_INF = -100.0  # IoU values are <= 1


class ATSSMatcher:
    """Adaptive Training Sample Selection (arXiv:1912.02424): per GT, the
    ``num_candidates * anchors_per_loc`` centre-closest anchors of each
    level; positives are the candidates at or above ``mean + std`` of their
    IoUs (optionally with the anchor centre inside the GT); an anchor claimed
    by several GTs goes to the one of highest IoU."""

    def __init__(self, num_candidates: int = 4, center_in_gt: bool = False,
                 min_dist: float = 0.01):
        self.num_candidates = num_candidates
        self.center_in_gt = center_in_gt
        self.min_dist = min_dist

    def __call__(
        self,
        gt_boxes: torch.Tensor,
        gt_mask: torch.Tensor,
        anchors: torch.Tensor,
        num_anchors_per_level: Sequence[int],
        num_anchors_per_loc: int,
    ) -> torch.Tensor:
        """``gt_boxes [..., G, 2*dim]``, ``gt_mask [..., G]``, ``anchors
        [A, 2*dim]`` (levels concatenated) -> ``matched_idx [..., A]``."""
        num_anchors = anchors.shape[0]
        if sum(num_anchors_per_level) != num_anchors:
            raise ValueError(f"levels hold {sum(num_anchors_per_level)} anchors, "
                             f"got {num_anchors}")
        distances, _, anchor_centers = box_center_dist(gt_boxes, anchors)  # [..., G, A]
        candidates = []
        start = 0
        for apl in num_anchors_per_level:
            k = min(self.num_candidates * num_anchors_per_loc, apl)
            _, idx = stable_topk(-distances[..., start:start + apl], k)
            candidates.append(idx + start)
            start += apl
        cand = torch.cat(candidates, dim=-1)  # [..., G, K]

        cand_ious = torch.gather(box_iou(gt_boxes, anchors), -1, cand)
        thresh = cand_ious.mean(dim=-1)
        if cand.shape[-1] > 1:
            thresh = thresh + cand_ious.std(dim=-1)  # ddof = 1
        is_pos = cand_ious >= thresh[..., None]
        if self.center_in_gt:
            in_gt = center_in_boxes(anchor_centers[cand], gt_boxes[..., None, :], eps=self.min_dist)
            is_pos = is_pos & in_gt
        is_pos = is_pos & gt_mask[..., None].bool()

        # each anchor goes to the positive GT of highest IoU (first on ties)
        overlaps = torch.full(distances.shape, _NEG_INF, dtype=torch.float32,
                              device=distances.device)
        overlaps.scatter_(-1, cand, torch.where(is_pos, cand_ious, _NEG_INF))
        matched_vals = overlaps.amax(dim=-2)
        matches = overlaps.argmax(dim=-2)
        return torch.where(matched_vals <= _NEG_INF, BELOW_LOW_THRESHOLD, matches)


class IoUMatcher:
    """IoU-threshold matching (torchvision semantics): below ``low`` is
    background, between the thresholds ignored; with
    ``allow_low_quality_matches`` every valid GT also gets its best anchor
    (the later GT wins where two share one)."""

    def __init__(self, low_threshold: float, high_threshold: float,
                 allow_low_quality_matches: bool = True):
        if low_threshold > high_threshold:
            raise ValueError(f"low threshold {low_threshold} above high {high_threshold}")
        self.low_threshold = low_threshold
        self.high_threshold = high_threshold
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(self, gt_boxes, gt_mask, anchors, num_anchors_per_level=None,
                 num_anchors_per_loc=None) -> torch.Tensor:
        gt_mask = gt_mask.bool()
        ious = torch.where(gt_mask[..., None], box_iou(gt_boxes, anchors), -1.0)  # [..., G, A]
        matched_vals = ious.amax(dim=-2)
        matches = ious.argmax(dim=-2)
        matches = torch.where(matched_vals < self.low_threshold, BELOW_LOW_THRESHOLD, matches)
        between = (matched_vals >= self.low_threshold) & (matched_vals < self.high_threshold)
        matches = torch.where(between, BETWEEN_THRESHOLDS, matches)
        if self.allow_low_quality_matches:
            num_gt, num_anchors = ious.shape[-2:]
            best = torch.where(gt_mask, ious.argmax(dim=-1), num_anchors)  # [..., G]
            rows = torch.arange(num_gt, device=ious.device).expand_as(best)
            winner = torch.full(best.shape[:-1] + (num_anchors + 1,), -1, dtype=torch.long,
                                device=ious.device)
            winner.scatter_reduce_(-1, best, rows, reduce="amax")
            winner = winner[..., :num_anchors]
            matches = torch.where(winner >= 0, winner, matches)
        return matches


def gather_matched(
    matched_idx: torch.Tensor, gt_boxes: torch.Tensor, gt_classes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-anchor targets of a match: ``labels [..., A]`` (GT class + 1 where
    matched, 0 background, -1 ignore) and ``matched_boxes [..., A, 2*dim]``
    float32 (row 0 of the GT where unmatched)."""
    idx = matched_idx.clamp(min=0)
    boxes = torch.gather(gt_boxes.float(), -2,
                         idx[..., None].expand(*idx.shape, gt_boxes.shape[-1]))
    labels = torch.gather(gt_classes.long(), -1, idx) + 1
    labels = torch.where(matched_idx == BELOW_LOW_THRESHOLD, 0, labels)
    labels = torch.where(matched_idx == BETWEEN_THRESHOLDS, -1, labels)
    return labels, boxes
