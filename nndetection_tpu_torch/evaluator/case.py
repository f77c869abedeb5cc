"""Patient-level (case) evaluation (copy of
:mod:`nndetection_tpu.evaluator.case`): each case's detections reduce to the
highest box score per class, scored as a patient classification (AUROC, AP)
against a target derived from the ground truth. The AUROC and AP are the
NumPy functions of :mod:`nndetection_tpu_torch.evaluator.froc`, with
scikit-learn's semantics."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from nndetection_tpu_torch.evaluator.froc import average_precision_score, roc_auc_score


class CaseEvaluator:
    def __init__(self, classes: Sequence[str], target_class: Optional[int] = None):
        self.classes = list(classes)
        self.target_class = target_class
        self.case_scores: List[np.ndarray] = []
        self.case_targets: List[int] = []

    def add_case(self, pred_scores: np.ndarray, pred_labels: np.ndarray,
                 gt_classes: np.ndarray) -> None:
        scores = np.zeros(len(self.classes))
        for c in range(len(self.classes)):
            m = np.asarray(pred_labels) == c
            if m.any():
                scores[c] = float(np.max(np.asarray(pred_scores)[m]))
        self.case_scores.append(scores)
        if self.target_class is not None:
            target = int(self.target_class in np.asarray(gt_classes))
        else:
            target = int(len(np.asarray(gt_classes)) > 0)
        self.case_targets.append(target)

    def finish_online_evaluation(self) -> Dict[str, float]:
        if not self.case_scores:
            return {}
        scores = np.stack(self.case_scores)
        targets = np.asarray(self.case_targets)
        s = scores[:, self.target_class] if self.target_class is not None else scores.max(axis=1)
        out: Dict[str, float] = {}
        if len(np.unique(targets)) > 1:
            out["case_auroc"] = roc_auc_score(targets, s)
            out["case_ap"] = average_precision_score(targets, s)
        else:
            out["case_auroc"] = float("nan")
            out["case_ap"] = float("nan")
        self.case_scores, self.case_targets = [], []
        return out
