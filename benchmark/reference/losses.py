"""Frozen copy, for the benchmark's reference, of the plain PyTorch code in
``nndetection_tpu_torch/losses.py``; it imports nothing of the program.

Loss functions, mask-weighted instead of index-compacted (counterpart of
:mod:`nndetection_tpu.losses`).

* ``bce_one_hot``: sigmoid BCE against a one-hot with the background column
  dropped, optional label smoothing; mean over sampled anchors x classes.
* ``focal_loss``: one-hot sigmoid focal loss, summed over sampled anchors.
* ``giou_loss``: negative summed GIoU over positives / #positives.
* ``smooth_l1_loss``: beta-parametrized smooth L1 over positives / #positives.
* ``softmax_ce_loss``, ``softmax_ce_masked``, ``topk_ce_loss``: softmax cross
  entropies; ``soft_dice_loss``: soft dice without the background channel;
  ``deep_supervision_seg_loss``: CE + dice over levels.

The JAX package writes class selections as one-hot contractions (TPU gathers
fetch a memory tile per element); the port gathers. Each contraction has one
non-zero term, so the numbers are the same.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .boxes import elementwise_generalized_box_iou


def one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0) -> torch.Tensor:
    """float32 one-hot with label smoothing."""
    oh = F.one_hot(labels.long(), num_classes).float()
    if smoothing > 0:
        oh = oh * (1.0 - smoothing) + smoothing / num_classes
    return oh


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise sigmoid BCE. At a logit of exactly 0
    (frequent in bfloat16) its gradient is JAX's: ``jnp.maximum`` splits a
    tie in half and ``jnp.abs`` takes slope +1, where ``clamp`` passes the
    whole gradient and ``abs`` takes slope 0."""
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * targets
            + torch.log1p(torch.exp(-abs_logits)))


def bce_one_hot(logits: torch.Tensor, target_labels: torch.Tensor, sample_mask: torch.Tensor,
                num_classes: int, smoothing: float = 0.0, loss_weight: float = 1.0) -> torch.Tensor:
    """Sigmoid BCE over the foreground classes, background (label 0) an
    all-zero row: ``logits [N, C]``, ``target_labels [N]``, ``sample_mask
    [N]``. Mean over sampled anchors x classes."""
    oh = one_hot_smooth(target_labels, num_classes + 1, smoothing)[..., 1:]
    per = _bce_with_logits(logits.float(), oh)
    w = sample_mask.float()
    denom = (w.sum() * num_classes).clamp(min=1.0)
    return loss_weight * (per * w[..., None]).sum() / denom


def focal_loss(logits: torch.Tensor, target_labels: torch.Tensor, sample_mask: torch.Tensor,
               num_classes: int, gamma: float = 2.0, alpha: float = -1.0,
               loss_weight: float = 1.0) -> torch.Tensor:
    """One-hot sigmoid focal loss, summed over sampled anchors."""
    oh = one_hot_smooth(target_labels, num_classes + 1)[..., 1:]
    logits32 = logits.float()
    bce = _bce_with_logits(logits32, oh)
    p = torch.sigmoid(logits32)
    pt = p * oh + (1 - p) * (1 - oh)
    loss = bce * (1 - pt) ** gamma
    if alpha >= 0:
        loss = (alpha * oh + (1 - alpha) * (1 - oh)) * loss
    return loss_weight * (loss * sample_mask.float()[..., None]).sum()


def giou_loss(pred_boxes: torch.Tensor, target_boxes: torch.Tensor, pos_mask: torch.Tensor,
              eps: float = 1e-7, loss_weight: float = 1.0) -> torch.Tensor:
    """Negative GIoU summed over positives, over ``max(1, #positives)``."""
    giou = elementwise_generalized_box_iou(pred_boxes, target_boxes, eps=eps)
    w = pos_mask.float()
    return loss_weight * -(giou * w).sum() / w.sum().clamp(min=1.0)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, pos_mask: torch.Tensor,
                   beta: float = 1.0 / 9, loss_weight: float = 1.0) -> torch.Tensor:
    """Smooth L1 summed over positives, over ``max(1, #positives)``."""
    n = (pred.float() - target.float()).abs()
    per = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    w = pos_mask.float()
    return loss_weight * (per.sum(-1) * w).sum() / w.sum().clamp(min=1.0)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def softmax_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax cross entropy of channel-last ``logits [..., C]`` against int
    ``targets [...]``; mean, or class-weighted mean as
    ``torch.nn.CrossEntropyLoss(weight=...)``."""
    nll = _nll(logits, targets)
    if weight is not None:
        w = weight.float()[targets.long()]
        return (nll * w).sum() / w.sum().clamp(min=1e-8)
    return nll.mean()


def softmax_ce_masked(logits: torch.Tensor, target_labels: torch.Tensor, sample_mask: torch.Tensor,
                      class_weights: Optional[torch.Tensor] = None,
                      loss_weight: float = 1.0) -> torch.Tensor:
    """Softmax CE over C+1 classes (background = column 0) on the sampled
    anchors: ``sum(w[y] * nll) / sum(w[y])``."""
    nll = _nll(logits, target_labels)
    w = sample_mask.float()
    if class_weights is not None:
        w = w * torch.as_tensor(class_weights, dtype=torch.float32,
                                device=logits.device)[target_labels.long()]
    return loss_weight * (nll * w).sum() / w.sum().clamp(min=1e-8)


def topk_ce_loss(logits: torch.Tensor, targets: torch.Tensor, topk_fraction: float) -> torch.Tensor:
    """Mean CE over the hardest ``topk_fraction`` percent of voxels."""
    nll = _nll(logits, targets).reshape(-1)
    k = max(1, int(nll.shape[0] * topk_fraction / 100.0))
    return torch.topk(nll, k).values.mean()


def maxpool_downsample_target(target: torch.Tensor, factor) -> torch.Tensor:
    """Project an int segmentation target ``[N, *spatial]`` to a coarser
    level by max pooling (window = stride = ``factor``, VALID)."""
    dims = target.ndim - 1
    if isinstance(factor, int):
        factor = (factor,) * dims
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[dims]
    # class ids are small integers: exact in float32
    return pool(target[:, None].float(), tuple(factor))[:, 0].to(target.dtype)


def deep_supervision_seg_loss(logits_list: Sequence[torch.Tensor], target: torch.Tensor, strides,
                              alpha: float = 0.5, batch_dice: bool = True) -> torch.Tensor:
    """CE + dice over levels, level weights halving and normalized."""
    weights = torch.tensor([0.5 ** i for i in range(len(logits_list))])
    weights = weights / weights.sum()
    total = 0.0
    for i, logits in enumerate(logits_list):
        tgt = target if i == 0 else maxpool_downsample_target(target, strides[i])
        ce = softmax_ce_loss(logits, tgt)
        dice = soft_dice_loss(logits, tgt, batch_dice=batch_dice, do_bg=False)
        total = total + weights[i].item() * (alpha * ce + (1 - alpha) * dice)
    return total


def soft_dice_loss(logits: torch.Tensor, targets: torch.Tensor, batch_dice: bool = True,
                   do_bg: bool = False, smooth_nom: float = 1e-5,
                   smooth_denom: float = 1e-5) -> torch.Tensor:
    """``1 - mean(dice)`` of the softmax of channel-last ``logits [N, *spatial,
    C]`` against int ``targets``."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    oh = F.one_hot(targets.long(), num_classes).float()
    axes = tuple(range(1, logits.ndim - 1))
    if batch_dice:
        axes = (0,) + axes
    tp = (probs * oh).sum(dim=axes)
    fp = (probs * (1 - oh)).sum(dim=axes)
    fn = ((1 - probs) * oh).sum(dim=axes)
    dc = (2 * tp + smooth_nom) / (2 * tp + fp + fn + smooth_denom)
    if not do_bg:
        dc = dc[..., 1:]
    return 1.0 - dc.mean()
