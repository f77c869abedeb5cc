"""FROC / CPM metric (copy of :mod:`nndetection_tpu.evaluator.froc`):
pooled-class free-response ROC, sensitivity interpolated at FPPI thresholds
1/8..8; score = mean sensitivity (the LUNA CPM).

The JAX package takes the ROC curve from scikit-learn's ``roc_curve`` (and
its case evaluator ``roc_auc_score`` and ``average_precision_score``); this
copy has its own :func:`roc_curve`, :func:`roc_auc_score` and
:func:`average_precision_score` in NumPy with the same semantics, so that
the port needs no scikit-learn.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# NumPy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def roc_curve(y_true: np.ndarray, y_score: np.ndarray, drop_intermediate: bool = True):
    """Binary ROC curve as ``sklearn.metrics.roc_curve`` computes it for
    labels in ``{0, 1}`` without sample weights: ``(fpr, tpr, thresholds)``
    at each distinct score from the highest down, after a first point
    ``(0, 0, inf)``; with ``drop_intermediate``, points collinear with their
    neighbours are dropped."""
    y_true = np.asarray(y_true).reshape(-1) == 1
    y_score = np.asarray(y_score).reshape(-1)
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[order]
    y_true = y_true[order].astype(np.float64)
    # the last index of each run of equal scores, and the end
    threshold_idxs = np.concatenate([np.nonzero(np.diff(y_score))[0], [y_true.size - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    thresholds = y_score[threshold_idxs]
    if drop_intermediate and fps.shape[0] > 2:
        corner = np.logical_or(np.diff(fps, 2), np.diff(tps, 2))
        optimal = np.nonzero(np.concatenate([[True], corner, [True]]))[0]
        fps, tps, thresholds = fps[optimal], tps[optimal], thresholds[optimal]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve as ``sklearn.metrics.roc_auc_score`` computes
    it for binary labels: the trapezoid over :func:`roc_curve`'s points (tied
    scores form one point)."""
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(_trapezoid(tpr, fpr))


def average_precision_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision as ``sklearn.metrics.average_precision_score``
    computes it for binary labels: the step sum of precision over the recall
    increments, one step per distinct score from the highest down."""
    y_true = np.asarray(y_true).reshape(-1) == 1
    y_score = np.asarray(y_score).reshape(-1)
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[order]
    y_true = y_true[order].astype(np.float64)
    threshold_idxs = np.concatenate([np.nonzero(np.diff(y_score))[0], [y_true.size - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1), 0.0)
    recall = tps / tps[-1] if tps[-1] > 0 else np.ones_like(tps)
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


class FROCMetric:
    def __init__(
        self,
        classes: Sequence[str],
        iou_thresholds: Sequence[float] = (0.1, 0.5),
        fpi_thresholds: Sequence[float] = (1 / 8, 1 / 4, 1 / 2, 1, 2, 4, 8),
        per_class: bool = False,
    ):
        self.classes = list(classes)
        self.iou_thresholds = list(iou_thresholds)
        self.fpi_thresholds = np.asarray(fpi_thresholds, dtype=np.float64)
        self.per_class = per_class

    def get_iou_thresholds(self):
        return self.iou_thresholds

    def compute(
        self, results_list: List[Dict[int, Dict[str, np.ndarray]]]
    ) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
        scores, curves = self.compute_froc_mul_iou(results_list)
        if self.per_class:
            s2, c2 = self.compute_froc_mul_iou_per_class(results_list)
            scores.update(s2)
            curves.update(c2)
        return scores, curves

    def compute_froc_mul_iou(self, results_list):
        num_images = len(results_list)
        results = [_r for r in results_list for _r in r.values()]
        if len(results) == 0:
            return (
                {"froc_score": 0.0},
                {"froc_curve": np.zeros(len(self.fpi_thresholds))},
            )
        dt_matches = np.concatenate([r["dtMatches"] for r in results], axis=1)
        dt_ignores = np.concatenate([r["dtIgnore"] for r in results], axis=1)
        dt_scores = np.concatenate([r["dtScores"] for r in results])
        gt_ignore = np.concatenate([r["gtIgnore"] for r in results])
        num_gt = int(np.count_nonzero(gt_ignore == 0))
        if num_gt == 0:
            return (
                {"froc_score": 0.0},
                {"froc_curve": np.zeros(len(self.fpi_thresholds))},
            )
        curves = {}
        for iou_idx, iou_val in enumerate(self.iou_thresholds):
            keep = np.logical_not(dt_ignores[iou_idx]).astype(bool)
            _scores = dt_scores[keep]
            _matches = dt_matches[iou_idx][keep]
            fps, sens, _ = self.compute_froc_curve_one_iou(
                _matches, _scores, num_images, num_gt
            )
            curves[iou_val] = np.interp(self.fpi_thresholds, fps, sens)
        scores = {
            f"FROC_score_IoU_{k:.2f}": float(np.mean(c)) for k, c in curves.items()
        }
        out_curves = {f"FROC_curve_IoU_{k:.2f}": c for k, c in curves.items()}
        out_curves["FROC_fpi_thresholds"] = self.fpi_thresholds
        return scores, out_curves

    @staticmethod
    def compute_froc_curve_one_iou(dt_matches, dt_scores, num_images, num_gt):
        num_det = len(dt_matches)
        num_matched = np.sum(dt_matches)
        num_unmatched = num_det - num_matched
        if dt_matches.size == 0 or len(np.unique(dt_matches)) < 2:
            # degenerate: all TP or all FP — construct curve manually
            order = np.argsort(-dt_scores, kind="mergesort")
            m = dt_matches[order]
            tp_cum = np.cumsum(m)
            fp_cum = np.cumsum(1 - m)
            fps = fp_cum / num_images
            sens = tp_cum / num_gt
            return (
                np.concatenate([[0.0], fps]),
                np.concatenate([[0.0], sens]),
                np.zeros(num_det + 1),
            )
        fpr, tpr, thresholds = roc_curve(dt_matches, dt_scores)
        fps = (fpr * num_unmatched) / num_images if num_unmatched else np.zeros(len(fpr))
        sens = (tpr * num_matched) / num_gt
        return fps, sens, thresholds

    def compute_froc_mul_iou_per_class(self, results_list):
        scores, curves = {}, {}
        for cls_idx, cls_str in enumerate(self.classes):
            sub = [
                {0: r[cls_idx]} for r in results_list if cls_idx in r
            ]
            s, c = self.compute_froc_mul_iou(sub)
            scores.update({f"{cls_str}_{k}": v for k, v in s.items()})
            curves.update({f"{cls_str}_{k}": v for k, v in c.items()})
        return scores, curves
