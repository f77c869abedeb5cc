"""Detection and segmentation evaluation on the host (copies of
:mod:`nndetection_tpu.evaluator`'s metric modules, NumPy)."""
from nndetection_tpu_torch.evaluator.coco import COCOMetric
from nndetection_tpu_torch.evaluator.det import BoxEvaluator, SegmentationEvaluator
from nndetection_tpu_torch.evaluator.froc import FROCMetric
from nndetection_tpu_torch.evaluator.hist import PredictionHistogram
from nndetection_tpu_torch.evaluator.matching import matching_batch

__all__ = [
    "COCOMetric",
    "FROCMetric",
    "BoxEvaluator",
    "SegmentationEvaluator",
    "PredictionHistogram",
    "matching_batch",
]
