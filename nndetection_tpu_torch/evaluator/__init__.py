"""Detection, case and segmentation evaluation on the host (copies of
:mod:`nndetection_tpu.evaluator`'s modules, NumPy; the greedy matching in
the port's native host library)."""
from nndetection_tpu_torch.evaluator.case import CaseEvaluator
from nndetection_tpu_torch.evaluator.coco import COCOMetric
from nndetection_tpu_torch.evaluator.det import BoxEvaluator, SegmentationEvaluator
from nndetection_tpu_torch.evaluator.froc import FROCMetric
from nndetection_tpu_torch.evaluator.hist import PredictionHistogram
from nndetection_tpu_torch.evaluator.matching import matching_batch
from nndetection_tpu_torch.evaluator.registry import (
    evaluate_box_dir,
    evaluate_case_dir,
    evaluate_seg_dir,
)

__all__ = [
    "COCOMetric",
    "FROCMetric",
    "BoxEvaluator",
    "SegmentationEvaluator",
    "CaseEvaluator",
    "PredictionHistogram",
    "matching_batch",
    "evaluate_box_dir",
    "evaluate_case_dir",
    "evaluate_seg_dir",
]
