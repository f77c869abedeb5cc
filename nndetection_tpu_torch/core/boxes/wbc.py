"""Weighted box clustering (counterpart of
:mod:`nndetection_tpu.core.boxes.wbc`).

Greedy clustering from the highest-scoring box: each cluster becomes one
score-weighted average box, with a score dampened by the number of *missing*
expected predictions.

:func:`wbc` and :func:`batched_wbc` are the device formulation, float32 with
outputs padded to ``[N]`` per class and a validity mask, in one launch of
the cluster kernel (:func:`nndetection_tpu_torch.ops.wbc_cluster.wbc_cluster`),
which computes the IoUs it needs on chip: no ``N x N`` matrix.
:func:`wbc_np` and :func:`batched_wbc_np` are the host formulation, float64:
the port's host library (``csrc/nndet_host.cpp``), or :func:`wbc_np_plain`
in NumPy without a C++ compiler.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nndetection_tpu_torch.core.boxes.ops import box_size, prod_last
from nndetection_tpu_torch.core.boxes.ops_np import box_area_np, box_iou_np
from nndetection_tpu_torch.ops.native import wbc_native
from nndetection_tpu_torch.ops.wbc_cluster import wbc_cluster


def batched_wbc(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    n_exp_preds: torch.Tensor,
    valid: torch.Tensor,
    iou_thresh: float,
    score_thresh: float = 0.0,
    use_area: bool = False,
    missing_weight: float = 1.0,
    num_classes: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class weighted box clustering on the device of the inputs.

    Args:
        boxes: ``[N, 2*dim]``
        scores, weights, n_exp_preds: ``[N]``
        labels: ``[N]`` integer classes; class ``c`` in ``0..num_classes-1``
            clusters the valid boxes of label ``c``
        valid: ``[N]`` bool
        iou_thresh: boxes with IoU > thresh w.r.t. the cluster seed join it
        score_thresh: clusters with consolidated score <= thresh are dropped
        use_area: multiply weights by box volume (area in 2D)
        missing_weight: dampening weight for missing predictions

    Returns ``(boxes [C*N, 2*dim], scores [C*N], labels [C*N], valid [C*N])``,
    class-major, each class's clusters in the order they formed.
    """
    n, n_coords = boxes.shape
    boxes32 = boxes.float().contiguous()
    w = weights.float()
    if use_area:
        w = w * prod_last(box_size(boxes32))
    ob, os_, ov = wbc_cluster(
        boxes32, scores.float().contiguous(), w.contiguous(),
        n_exp_preds.float().contiguous(), labels.to(torch.int32).contiguous(),
        valid.bool().contiguous(), num_classes, iou_thresh, score_thresh, missing_weight)
    out_labels = torch.arange(num_classes, dtype=torch.int32, device=boxes.device)
    return (ob.reshape(num_classes * n, n_coords), os_.reshape(-1),
            out_labels.repeat_interleave(n), ov.reshape(-1))


def wbc(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    weights: torch.Tensor,
    n_exp_preds: torch.Tensor,
    valid: torch.Tensor,
    iou_thresh: float,
    score_thresh: float = 0.0,
    use_area: bool = False,
    missing_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-class weighted box clustering on the device of the inputs.

    Arguments as :func:`batched_wbc` without labels. Returns
    ``(boxes [N, 2*dim], scores [N], valid [N])``, clusters in the order they
    formed (descending seed score), padded.
    """
    labels = torch.zeros(boxes.shape[0], dtype=torch.int32, device=boxes.device)
    b, s, _, v = batched_wbc(boxes, scores, labels, weights, n_exp_preds, valid, iou_thresh,
                             score_thresh, use_area, missing_weight, num_classes=1)
    return b, s, v


def wbc_np(
    boxes: np.ndarray,
    scores: np.ndarray,
    weights: np.ndarray,
    n_exp_preds: np.ndarray,
    iou_thresh: float,
    score_thresh: float = 0.0,
    use_area: bool = False,
    missing_weight: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-class weighted box clustering on the host, float64: 3D boxes
    go to the host library (:func:`nndetection_tpu_torch.ops.native.wbc_native`);
    without a C++ compiler, and for 2D boxes, :func:`wbc_np_plain` runs.
    Arguments and result as :func:`wbc_np_plain`."""
    if len(boxes) == 0:
        return np.zeros((0, boxes.shape[-1] if boxes.ndim == 2 else 6)), np.zeros((0,))
    out = wbc_native(boxes, scores, weights, n_exp_preds, iou_thresh=iou_thresh,
                     score_thresh=score_thresh, use_area=use_area, missing_weight=missing_weight)
    if out is not None:
        return out
    return wbc_np_plain(boxes, scores, weights, n_exp_preds, iou_thresh, score_thresh,
                        use_area, missing_weight)


def wbc_np_plain(
    boxes: np.ndarray,
    scores: np.ndarray,
    weights: np.ndarray,
    n_exp_preds: np.ndarray,
    iou_thresh: float,
    score_thresh: float = 0.0,
    use_area: bool = False,
    missing_weight: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-class weighted box clustering in NumPy.

    Args:
        boxes: ``[N, 2*dim]``
        scores: ``[N]``
        weights: per-box weights (tile-border down-weighting etc.) ``[N]``
        n_exp_preds: expected number of predictions per box ``[N]``
        iou_thresh: boxes with IoU > thresh w.r.t. the cluster seed join it
        score_thresh: clusters with consolidated score <= thresh are dropped
        use_area: multiply weights by box area
        missing_weight: dampening weight for missing predictions

    Returns:
        ``(boxes [K, 2*dim], scores [K])`` in the order the clusters formed.
    """
    if len(boxes) == 0:
        return np.zeros((0, boxes.shape[-1] if boxes.ndim == 2 else 6)), np.zeros((0,))
    boxes = boxes.astype(np.float64)
    scores = scores.astype(np.float64)
    w = weights.astype(np.float64)
    if use_area:
        w = w * box_area_np(boxes)
    ious = box_iou_np(boxes, boxes)
    idx_pool = np.argsort(-scores, kind="stable")
    out_boxes, out_scores = [], []
    while idx_pool.size > 0:
        seed = idx_pool[0]
        m = ious[seed][idx_pool] > iou_thresh
        cluster = idx_pool[m]
        if len(cluster):
            n_found = len(cluster)
            n_expected = float(np.mean(n_exp_preds[cluster]))
            msw = ious[seed][cluster] * w[cluster]
            ms = msw * scores[cluster]
            n_missing = max(0.0, n_expected - n_found)
            denom = msw.sum() + n_missing * msw.mean() * missing_weight
            new_score = ms.sum() / denom
            new_box = (boxes[cluster] * ms[:, None]).sum(0) / ms.sum()
            if new_score > score_thresh:
                out_boxes.append(new_box)
                out_scores.append(new_score)
        # the seed leaves the pool even when it does not overlap itself (zero
        # volume): an empty cluster, dropped
        m[0] = True
        idx_pool = idx_pool[~m]
    if out_boxes:
        return np.stack(out_boxes, 0), np.asarray(out_scores)
    return np.zeros((0, boxes.shape[-1])), np.zeros((0,))


def batched_wbc_np(
    boxes: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    weights: np.ndarray,
    n_exp_preds: np.ndarray,
    iou_thresh: float,
    score_thresh: float = 0.0,
    use_area: bool = False,
    missing_weight: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class :func:`wbc_np`; returns ``(boxes, scores, labels)``."""
    outs_b, outs_s, outs_l = [], [], []
    for c in np.unique(labels):
        m = labels == c
        b, s = wbc_np(
            boxes[m],
            scores[m],
            weights[m],
            n_exp_preds[m],
            iou_thresh=iou_thresh,
            score_thresh=score_thresh,
            use_area=use_area,
            missing_weight=missing_weight,
        )
        outs_b.append(b)
        outs_s.append(s)
        outs_l.append(np.full(len(s), c))
    if outs_b:
        return (
            np.concatenate(outs_b, 0),
            np.concatenate(outs_s, 0),
            np.concatenate(outs_l, 0),
        )
    d = boxes.shape[-1] if boxes.ndim == 2 else 6
    return np.zeros((0, d)), np.zeros((0,)), np.zeros((0,))
