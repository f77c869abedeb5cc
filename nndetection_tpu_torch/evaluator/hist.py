"""TP/FP score histograms per IoU threshold (copy of
:mod:`nndetection_tpu.evaluator.hist`)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class PredictionHistogram:
    def __init__(
        self,
        classes: Sequence[str],
        iou_thresholds: Sequence[float] = (0.1, 0.5),
        bins: int = 20,
    ):
        self.classes = list(classes)
        self.iou_thresholds = list(iou_thresholds)
        self.bins = bins

    def get_iou_thresholds(self):
        return self.iou_thresholds

    def compute(
        self, results_list: List[Dict[int, Dict[str, np.ndarray]]]
    ) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
        curves: Dict[str, np.ndarray] = {}
        edges = np.linspace(0.0, 1.0, self.bins + 1)
        for iou_idx, iou in enumerate(self.iou_thresholds):
            scores_tp, scores_fp = [], []
            for per_img in results_list:
                for res in per_img.values():
                    s = res["dtScores"]
                    if s.size == 0:
                        continue
                    m = res["dtMatches"][iou_idx].astype(bool)
                    ig = res["dtIgnore"][iou_idx].astype(bool)
                    scores_tp.append(s[m & ~ig])
                    scores_fp.append(s[~m & ~ig])
            tp = np.concatenate(scores_tp) if scores_tp else np.zeros(0)
            fp = np.concatenate(scores_fp) if scores_fp else np.zeros(0)
            curves[f"hist_tp_IoU_{iou:.2f}"] = np.histogram(tp, bins=edges)[0]
            curves[f"hist_fp_IoU_{iou:.2f}"] = np.histogram(fp, bins=edges)[0]
        curves["hist_bin_edges"] = edges
        return {}, curves
