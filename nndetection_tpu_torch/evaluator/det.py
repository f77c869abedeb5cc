"""Online detection evaluator accumulating COCO matchings across batches
(copy of :mod:`nndetection_tpu.evaluator.det`)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nndetection_tpu_torch.evaluator.coco import COCOMetric
from nndetection_tpu_torch.evaluator.froc import FROCMetric
from nndetection_tpu_torch.evaluator.matching import matching_batch


class BoxEvaluator:
    def __init__(
        self,
        classes: Sequence[str],
        metrics: Sequence = (),
        max_detections: int = 100,
    ):
        self.classes = list(classes)
        self.metrics = list(metrics)
        self.max_detections = max_detections
        ious = sorted(
            {float(t) for m in self.metrics for t in m.get_iou_thresholds()}
        )
        self.iou_thresholds = ious
        self.results_list: List[dict] = []

    @classmethod
    def create(
        cls,
        classes: Sequence[str],
        fast: bool = True,
        max_detections: int = 100,
        per_class: Optional[bool] = None,
    ) -> "BoxEvaluator":
        """``fast`` preset = training-time online eval (IoU {0.1, 0.5} list,
        0.1:0.5:0.05 range, no per-class); full preset adds per-class AP and
        FROC."""
        if fast:
            metrics = [
                COCOMetric(
                    classes,
                    iou_list=(0.1, 0.5),
                    iou_range=(0.1, 0.5, 0.05),
                    max_detection=(max_detections,),
                    per_class=False if per_class is None else per_class,
                )
            ]
        else:
            from nndetection_tpu_torch.evaluator.hist import PredictionHistogram

            metrics = [
                COCOMetric(
                    classes,
                    iou_list=(0.1, 0.5, 0.75),
                    iou_range=(0.1, 0.5, 0.05),
                    max_detection=(1, 5, max_detections),
                    per_class=True if per_class is None else per_class,
                ),
                FROCMetric(classes, per_class=len(classes) > 1),
                PredictionHistogram(classes),
            ]
        return cls(classes, metrics, max_detections)

    # ------------------------------------------------------------------
    def add_batch(
        self,
        pred_boxes: np.ndarray,
        pred_scores: np.ndarray,
        pred_labels: np.ndarray,
        gt_boxes: np.ndarray,
        gt_classes: np.ndarray,
        pred_valid: Optional[np.ndarray] = None,
        gt_mask: Optional[np.ndarray] = None,
        gt_ignore: Optional[Sequence[np.ndarray]] = None,
    ) -> None:
        """Accumulate one batch. Accepts either padded fixed-size arrays with
        validity masks (device outputs) or lists of ragged arrays."""
        pb, ps, pl, gb, gc, gi = [], [], [], [], [], []
        n = len(pred_boxes)
        for i in range(n):
            if pred_valid is not None:
                v = np.asarray(pred_valid[i]).astype(bool)
                pb.append(np.asarray(pred_boxes[i])[v])
                ps.append(np.asarray(pred_scores[i])[v])
                pl.append(np.asarray(pred_labels[i])[v])
            else:
                pb.append(np.asarray(pred_boxes[i]))
                ps.append(np.asarray(pred_scores[i]))
                pl.append(np.asarray(pred_labels[i]))
            if gt_mask is not None:
                m = np.asarray(gt_mask[i]).astype(bool)
                gb.append(np.asarray(gt_boxes[i])[m])
                gc.append(np.asarray(gt_classes[i])[m])
            else:
                gb.append(np.asarray(gt_boxes[i]))
                gc.append(np.asarray(gt_classes[i]))
            gi.append(
                np.zeros(len(gb[-1]), dtype=bool)
                if gt_ignore is None
                else np.asarray(gt_ignore[i])
            )
        self.results_list.extend(
            matching_batch(
                iou_thresholds=self.iou_thresholds,
                pred_boxes=pb,
                pred_classes=pl,
                pred_scores=ps,
                gt_boxes=gb,
                gt_classes=gc,
                gt_ignore=gi,
                max_detections=self.max_detections,
            )
        )

    def finish_online_evaluation(self) -> Tuple[Dict[str, float], Dict]:
        """Compute all metrics over accumulated matchings and reset."""
        scores: Dict[str, float] = {}
        curves: Dict = {}
        for metric in self.metrics:
            # remap metric-specific iou threshold indices
            idx = [self.iou_thresholds.index(float(t)) for t in metric.get_iou_thresholds()]
            sub = [
                {
                    c: {
                        "dtMatches": r[c]["dtMatches"][idx],
                        "gtMatches": r[c]["gtMatches"][idx],
                        "dtScores": r[c]["dtScores"],
                        "gtIgnore": r[c]["gtIgnore"],
                        "dtIgnore": r[c]["dtIgnore"][idx],
                    }
                    for c in r
                }
                for r in self.results_list
            ]
            s, c = metric.compute(sub)
            scores.update(s)
            if c:
                curves.update(c)
        self.results_list = []
        return scores, curves


class SegmentationEvaluator:
    """Online proxy foreground dice."""

    def __init__(self):
        self.tp = self.fp = self.fn = 0.0

    def add_batch(self, pred_fg: np.ndarray, gt_fg: np.ndarray) -> None:
        pred = np.asarray(pred_fg).astype(bool)
        gt = np.asarray(gt_fg).astype(bool)
        self.tp += float(np.sum(pred & gt))
        self.fp += float(np.sum(pred & ~gt))
        self.fn += float(np.sum(~pred & gt))

    def finish_online_evaluation(self) -> Dict[str, float]:
        dice = 2 * self.tp / max(2 * self.tp + self.fp + self.fn, 1e-8)
        self.tp = self.fp = self.fn = 0.0
        return {"seg_dice_fg": dice}
