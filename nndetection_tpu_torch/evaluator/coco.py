"""COCO-style AP metrics, 101-point interpolated (copy of
:mod:`nndetection_tpu.evaluator.coco`), with nnDetection's metric keys, e.g.
``mAP_IoU_0.10_0.50_0.05_MaxDet_100``.

The precision/recall accumulation is pycocotools' ``COCOeval.accumulate``
(score-sorted cumulative sums, box-shape precision smoothing, recall
interpolation by ``searchsorted``) over the matching results of
:mod:`nndetection_tpu_torch.evaluator.matching`.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class COCOMetric:
    def __init__(
        self,
        classes: Sequence[str],
        iou_list: Sequence[float] = (0.1, 0.5, 0.75),
        iou_range: Sequence[float] = (0.1, 0.5, 0.05),
        max_detection: Sequence[int] = (1, 5, 100),
        per_class: bool = True,
    ):
        self.classes = list(classes)
        self.per_class = per_class
        iou_list = np.array(iou_list)
        _iou_range = np.linspace(
            iou_range[0],
            iou_range[1],
            int(np.round((iou_range[1] - iou_range[0]) / iou_range[2])) + 1,
            endpoint=True,
        )
        self.iou_thresholds = np.union1d(iou_list, _iou_range)
        self.iou_range = iou_range
        self.iou_list_idx = np.nonzero(
            iou_list[:, None] == self.iou_thresholds[None]
        )[1]
        self.iou_range_idx = np.nonzero(
            _iou_range[:, None] == self.iou_thresholds[None]
        )[1]
        self.recall_thresholds = np.linspace(0.0, 1.0, 101, endpoint=True)
        self.max_detections = list(max_detection)

    def get_iou_thresholds(self):
        return self.iou_thresholds

    # ------------------------------------------------------------------
    def compute(
        self, results_list: List[Dict[int, Dict[str, np.ndarray]]]
    ) -> Tuple[Dict[str, float], None]:
        stats = self.compute_statistics(results_list)
        results = {}
        md = self.max_detections[-1]
        key = (
            f"mAP_IoU_{self.iou_range[0]:.2f}_{self.iou_range[1]:.2f}_"
            f"{self.iou_range[2]:.2f}_MaxDet_{md}"
        )
        results[key] = self.select_ap(stats, iou_idx=self.iou_range_idx, max_det_idx=-1)
        if self.per_class:
            for cls_idx, cls_str in enumerate(self.classes):
                k = (
                    f"{cls_str}_mAP_IoU_{self.iou_range[0]:.2f}_"
                    f"{self.iou_range[1]:.2f}_{self.iou_range[2]:.2f}_MaxDet_{md}"
                )
                results[k] = self.select_ap(
                    stats, iou_idx=self.iou_range_idx, cls_idx=cls_idx, max_det_idx=-1
                )
        for idx in self.iou_list_idx:
            key = f"AP_IoU_{self.iou_thresholds[idx]:.2f}_MaxDet_{md}"
            results[key] = self.select_ap(stats, iou_idx=[idx], max_det_idx=-1)
            if self.per_class:
                for cls_idx, cls_str in enumerate(self.classes):
                    k = f"{cls_str}_AP_IoU_{self.iou_thresholds[idx]:.2f}_MaxDet_{md}"
                    results[k] = self.select_ap(
                        stats, iou_idx=[idx], cls_idx=cls_idx, max_det_idx=-1
                    )
        # AR at max detection thresholds over iou range
        for md_idx, md_val in enumerate(self.max_detections):
            key = (
                f"AR_IoU_{self.iou_range[0]:.2f}_{self.iou_range[1]:.2f}_"
                f"{self.iou_range[2]:.2f}_MaxDet_{md_val}"
            )
            results[key] = self.select_ar(stats, max_det_idx=md_idx)
        return results, None

    @staticmethod
    def select_ap(stats, iou_idx=None, cls_idx=None, max_det_idx=-1) -> float:
        prec = stats["precision"]
        if iou_idx is not None:
            prec = prec[iou_idx]
        if cls_idx is not None:
            prec = prec[..., cls_idx, :]
        prec = prec[..., max_det_idx]
        valid = prec[prec > -1]
        return float(np.mean(valid)) if valid.size else 0.0

    @staticmethod
    def select_ar(stats, iou_idx=None, cls_idx=None, max_det_idx=-1) -> float:
        rec = stats["recall"]
        if iou_idx is not None:
            rec = rec[iou_idx]
        if cls_idx is not None:
            rec = rec[..., cls_idx, :]
        rec = rec[..., max_det_idx]
        valid = rec[rec > -1]
        return float(np.mean(valid)) if valid.size else 0.0

    # ------------------------------------------------------------------
    def compute_statistics(self, results_list) -> dict:
        num_iou = len(self.iou_thresholds)
        num_recall = len(self.recall_thresholds)
        num_classes = len(self.classes)
        num_md = len(self.max_detections)
        precision = -np.ones((num_iou, num_recall, num_classes, num_md))
        recall = -np.ones((num_iou, num_classes, num_md))
        scores = -np.ones((num_iou, num_recall, num_classes, num_md))

        for cls_idx in range(num_classes):
            results = [r[cls_idx] for r in results_list if cls_idx in r]
            if not results:
                continue
            for md_idx, max_det in enumerate(self.max_detections):
                dt_scores = np.concatenate(
                    [r["dtScores"][:max_det] for r in results]
                )
                inds = np.argsort(-dt_scores, kind="mergesort")
                dt_scores_sorted = dt_scores[inds]
                dt_matches = np.concatenate(
                    [r["dtMatches"][:, :max_det] for r in results], axis=1
                )[:, inds]
                dt_ignores = np.concatenate(
                    [r["dtIgnore"][:, :max_det] for r in results], axis=1
                )[:, inds]
                gt_ignore = np.concatenate([r["gtIgnore"] for r in results])
                num_gt = int(np.count_nonzero(gt_ignore == 0))
                if num_gt == 0:
                    continue
                tps = np.logical_and(dt_matches, np.logical_not(dt_ignores))
                fps = np.logical_and(
                    np.logical_not(dt_matches), np.logical_not(dt_ignores)
                )
                tp_sum = np.cumsum(tps, axis=1).astype(np.float32)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float32)
                for th_ind, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                    r, p, s = compute_stats_single_threshold(
                        tp, fp, dt_scores_sorted, self.recall_thresholds, num_gt
                    )
                    recall[th_ind, cls_idx, md_idx] = r
                    precision[th_ind, :, cls_idx, md_idx] = p
                    scores[th_ind, :, cls_idx, md_idx] = s
        return {
            "counts": [num_iou, num_recall, num_classes, num_md],
            "recall": recall,
            "precision": precision,
            "scores": scores,
        }


def compute_stats_single_threshold(
    tp: np.ndarray,
    fp: np.ndarray,
    dt_scores_sorted: np.ndarray,
    recall_thresholds: Sequence[float],
    num_gt: int,
):
    """Precision/recall interpolation at fixed recall thresholds."""
    num_recall_th = len(recall_thresholds)
    rc = tp / num_gt
    pr = tp / (fp + tp + np.spacing(1))
    recall = rc[-1] if len(tp) else 0.0

    precision = np.zeros((num_recall_th,))
    th_scores = np.zeros((num_recall_th,))
    pr = pr.tolist()
    # box-shape smoothing of the precision curve
    for i in range(len(tp) - 1, 0, -1):
        if pr[i] > pr[i - 1]:
            pr[i - 1] = pr[i]
    inds = np.searchsorted(rc, recall_thresholds, side="left")
    for save_idx, array_index in enumerate(inds):
        if array_index < len(pr):
            precision[save_idx] = pr[array_index]
            th_scores[save_idx] = dt_scores_sorted[array_index]
    return recall, precision, th_scores
