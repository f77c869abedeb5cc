"""COCO-style greedy matching of predictions to ground truth (copy of
:mod:`nndetection_tpu.evaluator.matching`, NumPy on the host).

Per image and class, detections sorted by score greedily claim the best
still-unmatched GT above each IoU threshold; ignored GT absorb detections
without counting as TP or FP. The result fields (``dtMatches``,
``gtMatches``, ``dtScores``, ``gtIgnore``, ``dtIgnore``) are pycocotools'
``COCOeval.evaluateImg`` contract, which the AP and FROC accumulation read.
The greedy loop runs in the port's host library
(:func:`nndetection_tpu_torch.ops.native.coco_match_native`), as the JAX
package runs it in its own; :func:`coco_match_plain` is the same loop in
Python, which runs only without a C++ compiler.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from nndetection_tpu_torch.core.boxes.ops_np import box_iou_np
from nndetection_tpu_torch.ops.native import coco_match_native


def matching_batch(
    iou_thresholds: Sequence[float],
    pred_boxes: Sequence[np.ndarray],
    pred_classes: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    gt_classes: Sequence[np.ndarray],
    gt_ignore: Sequence[np.ndarray] = None,
    max_detections: int = 100,
    iou_fn: Callable = box_iou_np,
) -> List[Dict[int, Dict[str, np.ndarray]]]:
    """Match a batch of images; returns per-image {class: matching dict}."""
    if gt_ignore is None:
        gt_ignore = [np.zeros(len(g), dtype=bool) for g in gt_boxes]
    results = []
    for pboxes, pclasses, pscores, gboxes, gclasses, gignore in zip(
        pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes, gt_ignore
    ):
        gignore = np.asarray(gignore).astype(int)
        img_classes = np.union1d(pclasses, gclasses)
        result = {}
        for c in img_classes:
            pm = pclasses == c
            gm = gclasses == c
            if not np.any(gm):
                result[int(c)] = _matching_no_gt(iou_thresholds, pscores[pm], max_detections)
            elif not np.any(pm):
                result[int(c)] = _matching_no_pred(iou_thresholds, gignore[gm])
            else:
                result[int(c)] = _matching_single_image_single_class(
                    iou_fn, pboxes[pm], pscores[pm], gboxes[gm], gignore[gm],
                    max_detections, iou_thresholds,
                )
        results.append(result)
    return results


def _matching_no_gt(iou_thresholds, pred_scores, max_detections):
    dt_ind = np.argsort(-pred_scores, kind="mergesort")[:max_detections]
    dt_scores = pred_scores[dt_ind]
    n = len(dt_scores)
    t = len(iou_thresholds)
    return {
        "dtMatches": np.zeros((t, n)),
        "gtMatches": np.zeros((t, 0)),
        "dtScores": dt_scores,
        "gtIgnore": np.zeros((0,)),
        "dtIgnore": np.zeros((t, n)),
    }


def _matching_no_pred(iou_thresholds, gt_ignore):
    t = len(iou_thresholds)
    n_gt = len(gt_ignore)
    return {
        "dtMatches": np.zeros((t, 0)),
        "gtMatches": np.zeros((t, n_gt)),
        "dtScores": np.zeros((0,)),
        "gtIgnore": np.asarray(gt_ignore).reshape(-1),
        "dtIgnore": np.zeros((t, 0)),
    }


def _matching_single_image_single_class(
    iou_fn, pred_boxes, pred_scores, gt_boxes, gt_ignore, max_detections, iou_thresholds
):
    dt_ind = np.argsort(-pred_scores, kind="mergesort")[:max_detections]
    pred_boxes = pred_boxes[dt_ind]
    pred_scores = pred_scores[dt_ind]

    gt_ind = np.argsort(gt_ignore, kind="mergesort")
    gt_boxes = gt_boxes[gt_ind]
    gt_ignore = gt_ignore[gt_ind]

    ious = iou_fn(pred_boxes, gt_boxes)
    thresholds = np.asarray(iou_thresholds, np.float64)
    out = coco_match_native(ious, gt_ignore.astype(np.uint8), thresholds)
    dt_match, gt_match, dt_ignore = (coco_match_plain(ious, gt_ignore, thresholds)
                                     if out is None else out)
    return {
        "dtMatches": dt_match,
        "gtMatches": gt_match,
        "dtScores": pred_scores,
        "gtIgnore": np.asarray(gt_ignore).reshape(-1),
        "dtIgnore": dt_ignore,
    }


def coco_match_plain(ious, gt_ignore, iou_thresholds):
    """The greedy loop in Python: predictions ``ious [n_pred, n_gt]`` sorted
    by descending score, ground truth with the ignored ones last. Returns
    ``(dt_match [T, n_pred], gt_match [T, n_gt], dt_ignore [T, n_pred])``."""
    num_preds, num_gts = ious.shape
    t = len(iou_thresholds)
    gt_match = np.zeros((t, num_gts))
    dt_match = np.zeros((t, num_preds))
    dt_ignore = np.zeros((t, num_preds))

    for tind, thr in enumerate(iou_thresholds):
        for dind in range(num_preds):
            best_iou = min(thr, 1 - 1e-10)
            m = -1
            for gind in range(num_gts):
                if gt_match[tind, gind] > 0:
                    continue
                if m > -1 and gt_ignore[m] == 0 and gt_ignore[gind] == 1:
                    break
                if ious[dind, gind] < best_iou:
                    continue
                best_iou = ious[dind, gind]
                m = gind
            if m == -1:
                continue
            dt_ignore[tind, dind] = int(gt_ignore[m])
            dt_match[tind, dind] = 1
            gt_match[tind, m] = 1
    return dt_match, gt_match, dt_ignore
