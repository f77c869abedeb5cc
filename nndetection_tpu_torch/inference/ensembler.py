"""Case-level ensembling of tiled, TTA'd, multi-model box predictions
(counterpart of ``BoxEnsemblerSelective`` of
:mod:`nndetection_tpu.inference.ensembler`, on its host NumPy path; the
other ensemblers, device WBC and state save/load come later):

* per tile: plateau border down-weighting of boxes, offset into case coords
* per model: top-k -> clip -> remove-small -> score-thresh -> weighted NMS
* cross-model: concat -> top-k -> per-class weighted box clustering with
  ``n_exp = num_models``
"""
from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Sequence

import numpy as np

from nndetection_tpu_torch.core.boxes.ops_np import (
    batched_nms_np,
    box_axis_vector_np,
    box_center_np,
    box_size_np,
    clip_boxes_to_image_np,
)
from nndetection_tpu_torch.core.boxes.wbc import batched_wbc_np


def batched_weighted_nms_model(boxes, scores, labels, weights, iou_thresh):
    """NMS ranked by score*weight, reporting raw scores."""
    return batched_nms_np(boxes, scores * weights, labels, iou_thresh)


def batched_nms_model(boxes, scores, labels, weights, iou_thresh):
    return batched_nms_np(boxes, scores, labels, iou_thresh)


def batched_wbc_ensemble(boxes, scores, labels, weights, iou_thresh, n_exp_preds, score_thresh):
    return batched_wbc_np(
        boxes, scores, labels, weights, n_exp_preds,
        iou_thresh=iou_thresh, score_thresh=score_thresh,
    )


def batched_nms_ensemble(boxes, scores, labels, weights, iou_thresh, n_exp_preds, score_thresh):
    keep = batched_nms_np(boxes, scores, labels, iou_thresh)
    m = scores[keep] > score_thresh
    return boxes[keep][m], scores[keep][m], labels[keep][m]


MODEL_NMS_FNS = {
    "weighted_nms": batched_weighted_nms_model,
    "nms": batched_nms_model,
}
ENSEMBLE_FNS = {
    "wbc": batched_wbc_ensemble,
    "nms": batched_nms_ensemble,
}


def _empty_result() -> Dict[str, np.ndarray]:
    return {
        "pred_boxes": np.zeros((0, 6)),
        "pred_scores": np.zeros((0,)),
        "pred_labels": np.zeros((0,), np.int64),
    }


class BoxEnsemblerSelective:
    """Accumulates per-tile box predictions keyed by model (stream), then
    consolidates them into the case's detections."""

    def __init__(
        self,
        case_shape: Sequence[int],
        parameters: Optional[Dict[str, Any]] = None,
        properties: Optional[Dict[str, Any]] = None,
    ):
        self.case_shape = tuple(int(s) for s in case_shape)
        self.parameters = dict(self.get_default_parameters())
        if parameters:
            self.parameters.update(parameters)
        self.properties = properties or {}
        self.model_results: Dict[Hashable, Dict[str, List[np.ndarray]]] = {}
        self.model_current: Optional[Hashable] = None
        self.model_weights: Dict[Hashable, float] = {}

    @classmethod
    def get_default_parameters(cls) -> Dict[str, Any]:
        return {
            "model_iou": 0.1,
            "model_nms_fn": "weighted_nms",
            "model_score_thresh": 0.0,
            "model_topk": 1000,
            "model_detections_per_image": 100,
            "ensemble_iou": 0.5,
            "ensemble_nms_fn": "wbc",
            "ensemble_topk": 1000,
            "remove_small_boxes": 1e-2,
            "ensemble_score_thresh": 0.0,
        }

    def add_model(self, name: Hashable, weight: float = 1.0) -> None:
        if name not in self.model_results:
            self.model_results[name] = {"boxes": [], "scores": [], "labels": [], "weights": []}
            self.model_weights[name] = weight
        self.model_current = name

    @staticmethod
    def _get_box_in_tile_weight(centers: np.ndarray, tile_size: Sequence[int]) -> np.ndarray:
        """Linear plateau from the tile center."""
        if len(centers) == 0:
            return np.zeros((0,), dtype=np.float32)
        tile_center = np.asarray(tile_size, dtype=np.float64) / 2.0
        max_dist = np.linalg.norm(tile_center)
        dist = np.linalg.norm(centers - tile_center[None], axis=1)
        return (1.0 - np.clip(dist / max_dist - 0.5, 0, None)).astype(np.float32)

    def process_tile(
        self,
        boxes: np.ndarray,
        scores: np.ndarray,
        labels: np.ndarray,
        tile_origin: Sequence[int],
        tile_size: Sequence[int],
    ) -> None:
        """Add one tile's predictions (patch coords) for the current model."""
        if self.model_current is None:
            raise RuntimeError("call add_model before process_tile")
        centers = box_center_np(boxes) if len(boxes) else np.zeros((0, 3))
        w = self._get_box_in_tile_weight(centers, tile_size)
        w = w * self.model_weights[self.model_current]
        dim = boxes.shape[-1] // 2 if len(boxes) else 3
        if len(boxes):
            offset = np.asarray(tile_origin, dtype=np.float32)
            boxes = boxes + box_axis_vector_np(offset, dim)[None]
        res = self.model_results[self.model_current]
        res["boxes"].append(np.asarray(boxes, np.float32).reshape(-1, 2 * dim))
        res["scores"].append(np.asarray(scores, np.float32).reshape(-1))
        res["labels"].append(np.asarray(labels, np.int64).reshape(-1))
        res["weights"].append(np.asarray(w, np.float32).reshape(-1))

    def _postprocess_image(self, boxes, probs, labels, weights):
        p = self.parameters
        idx = np.argsort(-probs, kind="stable")[: p["model_topk"]]
        boxes, probs, labels, weights = boxes[idx], probs[idx], labels[idx], weights[idx]

        boxes = clip_boxes_to_image_np(boxes, self.case_shape)
        keep = np.all(box_size_np(boxes) >= p["remove_small_boxes"], axis=-1)
        keep &= probs > p["model_score_thresh"]
        boxes, probs, labels, weights = boxes[keep], probs[keep], labels[keep], weights[keep]
        if len(boxes):
            nms_fn = MODEL_NMS_FNS[p["model_nms_fn"]]
            keep_idx = nms_fn(boxes, probs, labels, weights, p["model_iou"])
            keep_idx = keep_idx[: p["model_detections_per_image"]]
            boxes, probs, labels, weights = (
                boxes[keep_idx], probs[keep_idx], labels[keep_idx], weights[keep_idx],
            )
        return boxes, probs, labels, weights

    def process_model(self, name: Hashable):
        res = self.model_results[name]
        return self._postprocess_image(
            np.concatenate(res["boxes"]) if res["boxes"] else np.zeros((0, 6)),
            np.concatenate(res["scores"]) if res["scores"] else np.zeros((0,)),
            np.concatenate(res["labels"]) if res["labels"] else np.zeros((0,)),
            np.concatenate(res["weights"]) if res["weights"] else np.zeros((0,)),
        )

    def get_case_result(self) -> Dict[str, np.ndarray]:
        """Consolidate all models -> final case detections."""
        p = self.parameters
        per_model = [self.process_model(name) for name in self.model_results]
        if not per_model:
            return _empty_result()
        boxes, probs, labels, weights = (
            np.concatenate([m[i] for m in per_model]) for i in range(4))

        idx = np.argsort(-probs, kind="stable")[: p["ensemble_topk"]]
        boxes, probs, labels, weights = boxes[idx], probs[idx], labels[idx], weights[idx]
        if len(boxes) == 0:
            return _empty_result()
        n_exp = np.full(len(boxes), len(per_model), dtype=np.float64)
        fn = ENSEMBLE_FNS[p["ensemble_nms_fn"]]
        b, s, l = fn(
            boxes, probs, labels, weights,
            iou_thresh=p["ensemble_iou"],
            n_exp_preds=n_exp,
            score_thresh=p["ensemble_score_thresh"],
        )
        order = np.argsort(-s, kind="stable")
        return {
            "pred_boxes": b[order],
            "pred_scores": s[order],
            "pred_labels": l[order].astype(np.int64),
        }


# name -> class, as the JAX package's ensembler registry
BOX_ENSEMBLERS = {"BoxEnsemblerSelective": BoxEnsemblerSelective}
