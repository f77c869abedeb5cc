"""Case-level ensembling of tiled, TTA'd, multi-model box predictions
(counterpart of :mod:`nndetection_tpu.inference.ensembler`, box ensemblers):

* per tile: border down-weighting of boxes, offset into case coordinates
* per model (stream): top-k -> clip -> remove-small -> score-thresh ->
  weighted NMS (``BoxEnsemblerSelective``)
* cross-model: concat -> top-k -> per-class weighted box clustering
* state save/load, so that post-processing sweeps re-run without
  re-predicting; a state written by either package loads in the other.

The whole-case WBC runs on the ensembler's device: with ``device`` on CUDA,
:func:`batched_wbc_device` clusters there through the kernels of
:mod:`nndetection_tpu_torch.core.boxes.wbc` (float32). ``device=None`` keeps
it on the host (float64), as the JAX package does off the TPU. The
model-level NMS follows the same rule: on CUDA, every stream whose
post-processing is not memoised goes through one launch of the truncated
NMS kernel (:func:`batched_model_nms_device`, float32 IoU, the same ranking
key and tie order); elsewhere each stream runs the host float64
``batched_nms_np``, as in the JAX package. On the host, both loops run in
the port's native library (:mod:`nndetection_tpu_torch.ops.native`), as the
JAX package runs them in its own; in NumPy only without a C++ compiler.

:class:`SegmentationEnsembler` stitches the tiles' softmax maps on its
device.

Under a profiler, consolidation records the spans ``ensemble.consolidate``
(each ``get_case_result``), ``ensemble.model_nms`` (the model-level
post-processing that is not memoised: each stream's on the host, all of a
consolidation's in one span on CUDA) and ``ensemble.cluster`` (the
whole-case WBC or NMS with its copy back), and the counter
``ensemble.streams_on_card`` (the streams of the batched launches)
(:mod:`nndetection_tpu_torch.utils.trace`).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nndetection_tpu_torch.core.boxes.ops_np import (
    batched_nms_np,
    box_axis_vector_np,
    box_center_np,
    box_size_np,
    clip_boxes_to_image_np,
)
from nndetection_tpu_torch.core.boxes.nms import batched_nms_topk
from nndetection_tpu_torch.core.boxes.wbc import batched_wbc, batched_wbc_np
from nndetection_tpu_torch.data.patching import tile_weight_map
from nndetection_tpu_torch.utils import trace
from nndetection_tpu_torch.utils.io import load_pickle, save_pickle

Device = Union[torch.device, str, None]


# --------------------------------------------------------------------------
# model/ensemble suppression functions (names match sweep space semantics)
# --------------------------------------------------------------------------
def batched_weighted_nms_model(boxes, scores, labels, weights, iou_thresh):
    """NMS ranked by score*weight, reporting raw scores."""
    return batched_nms_np(boxes, scores * weights, labels, iou_thresh)


def batched_nms_model(boxes, scores, labels, weights, iou_thresh):
    return batched_nms_np(boxes, scores, labels, iou_thresh)


def batched_model_nms_device(
    streams: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    iou_thresh: float,
    max_out: int,
    device: Device = None,
) -> List[np.ndarray]:
    """The model-level NMS of several streams in one launch of
    :func:`batched_nms_topk` on ``device``. ``streams``: each stream's
    ``(boxes [n, 2*dim], ranking key [n], labels [n])``; padded to the
    longest into one array, copied to the device once, and the kept
    indices copied back once. Returns each stream's kept indices, best
    first, at most ``max_out``: ``batched_nms_np(...)[:max_out]`` with the
    IoU in float32 instead of float64."""
    n = max((len(b) for b, _, _ in streams), default=0)
    if n == 0:
        return [np.zeros((0,), np.int64) for _ in streams]
    width = streams[0][0].shape[1]
    # boxes, key, label, valid along the last axis
    packed = np.zeros((len(streams), n, width + 3), np.float32)
    for row, (boxes, key, labels) in zip(packed, streams):
        k = len(boxes)
        row[:k, :width] = boxes
        row[:k, width] = key
        row[:k, width + 1] = labels
        row[:k, width + 2] = 1.0
    t = torch.from_numpy(packed).to(torch.device("cpu" if device is None else device))
    idx, kept = batched_nms_topk(t[..., :width], t[..., width], t[..., width + 1].long(),
                                 t[..., width + 2] > 0, iou_thresh, max_out)
    rows = torch.where(kept, idx, -1).cpu().numpy()
    return [row[row >= 0] for row in rows]


# Where the whole-case WBC runs: "auto" -> on the ensembler's device when it
# is CUDA, on the host otherwise (the JAX package's "auto": the TPU only);
# True -> the device formulation on the ensembler's device (the kernels'
# plain versions on the CPU); False -> host NumPy.
DEVICE_WBC: Union[str, bool] = "auto"


def _use_device_wbc(device: Device) -> bool:
    if DEVICE_WBC == "auto":
        return device is not None and torch.device(device).type == "cuda"
    return bool(DEVICE_WBC)


def _use_device_model_nms(device: Device) -> bool:
    """The model-level NMS runs on the device on CUDA, on the host otherwise."""
    return device is not None and torch.device(device).type == "cuda"


def batched_wbc_device(
    boxes, scores, labels, weights, n_exp_preds, iou_thresh, score_thresh, device: Device = None
):
    """The device formulation of the whole-case WBC on NumPy inputs:
    ``(boxes, scores, labels int64)`` of the emitted clusters, class-major.
    Unlike the JAX package, no padding to a power of two: that exists for
    XLA's compile cache."""
    dev = torch.device("cpu" if device is None else device)
    n = len(boxes)
    num_classes = max(1, int(labels.max()) + 1) if n else 1

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    ob, os_, ol, ov = batched_wbc(
        put(boxes, np.float32), put(scores, np.float32), put(labels, np.int32),
        put(weights, np.float32), put(n_exp_preds, np.float32),
        torch.ones(n, dtype=torch.bool, device=dev),
        iou_thresh=iou_thresh, score_thresh=score_thresh, num_classes=num_classes,
    )
    return ob[ov].cpu().numpy(), os_[ov].cpu().numpy(), ol[ov].cpu().numpy().astype(np.int64)


def batched_wbc_ensemble(boxes, scores, labels, weights, iou_thresh, n_exp_preds, score_thresh,
                         device: Device = None):
    if len(boxes) and _use_device_wbc(device):
        return batched_wbc_device(
            boxes, scores, labels, weights, n_exp_preds,
            iou_thresh=iou_thresh, score_thresh=score_thresh, device=device,
        )
    return batched_wbc_np(
        boxes, scores, labels, weights, n_exp_preds,
        iou_thresh=iou_thresh, score_thresh=score_thresh,
    )


def batched_nms_ensemble(boxes, scores, labels, weights, iou_thresh, n_exp_preds, score_thresh,
                         device: Device = None):
    keep = batched_nms_np(boxes, scores, labels, iou_thresh)
    m = scores[keep] > score_thresh
    return boxes[keep][m], scores[keep][m], labels[keep][m]


MODEL_NMS_FNS = {
    "weighted_nms": batched_weighted_nms_model,
    "nms": batched_nms_model,
}
# the ranking key of each, for the batched launch on the device
MODEL_NMS_KEYS = {
    "weighted_nms": lambda probs, weights: probs * weights,
    "nms": lambda probs, weights: probs,
}
ENSEMBLE_FNS = {
    "wbc": batched_wbc_ensemble,
    "nms": batched_nms_ensemble,
}


def _empty_result(dim: int) -> Dict[str, np.ndarray]:
    return {
        "pred_boxes": np.zeros((0, 2 * dim)),
        "pred_scores": np.zeros((0,)),
        "pred_labels": np.zeros((0,), np.int64),
    }


def _concat_or_empty(parts: List[np.ndarray], empty_shape) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros(empty_shape)


class BoxEnsemblerSelective:
    """Accumulates per-tile box predictions keyed by model (stream), then
    consolidates them into the case's detections."""

    def __init__(
        self,
        case_shape: Sequence[int],
        parameters: Optional[Dict[str, Any]] = None,
        properties: Optional[Dict[str, Any]] = None,
        device: Device = None,
    ):
        """``device``: where the whole-case WBC runs (see :data:`DEVICE_WBC`);
        ``None`` is the host."""
        self.case_shape = tuple(int(s) for s in case_shape)
        self.parameters = dict(self.get_default_parameters())
        if parameters:
            self.parameters.update(parameters)
        self.properties = properties or {}
        self.device = None if device is None else torch.device(device)
        self.model_results: Dict[Hashable, Dict[str, List[np.ndarray]]] = {}
        self.model_current: Optional[Hashable] = None
        self.model_weights: Dict[Hashable, float] = {}
        # sweep-time memoization: per-model concatenated streams and
        # post-processed results keyed by the model-level parameters. The
        # sweeper re-runs get_case_result ~25x per case with one parameter
        # changed at a time; ensemble-level trials reuse the per-model NMS
        # output unchanged.
        self._concat_cache: Dict[Hashable, Tuple[np.ndarray, ...]] = {}
        self._model_post_cache: Dict[Tuple, Tuple[np.ndarray, ...]] = {}

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

    @classmethod
    def sweep_parameters(cls) -> Tuple[Dict[str, Any], Dict[str, Sequence[Any]]]:
        """Default parameters and the sweep space."""
        iou_threshs = np.linspace(0.0, 0.5, 6)
        iou_threshs[0] = 1e-5
        small = [1e-2] + np.linspace(2.0, 7.0, 6).tolist()
        return cls.get_default_parameters(), {
            "model_iou": iou_threshs.tolist(),
            "model_nms_fn": ["weighted_nms", "nms"],
            "ensemble_iou": iou_threshs.tolist(),
            "model_score_thresh": [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6],
            "remove_small_boxes": small,
        }

    def update_parameters(self, **kwargs) -> None:
        self.parameters.update(kwargs)

    # ------------------------------------------------------------------
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
        dim = len(self.case_shape)
        if len(boxes):
            offset = np.asarray(tile_origin, dtype=np.float32)
            boxes = boxes + box_axis_vector_np(offset, dim)[None]
        res = self.model_results[self.model_current]
        res["boxes"].append(np.asarray(boxes, np.float32).reshape(-1, 2 * dim))
        res["scores"].append(np.asarray(scores, np.float32).reshape(-1))
        res["labels"].append(np.asarray(labels, np.int64).reshape(-1))
        res["weights"].append(np.asarray(w, np.float32).reshape(-1))
        # new predictions invalidate any memoized post-processing
        self._concat_cache.clear()
        self._model_post_cache.clear()

    # ------------------------------------------------------------------
    def _concat(self, name: Hashable) -> Tuple[np.ndarray, ...]:
        """One stream's tiles as ``(boxes, scores, labels, weights)``."""
        cat = self._concat_cache.get(name)
        if cat is None:
            res = self.model_results[name]
            cat = (
                _concat_or_empty(res["boxes"], (0, 2 * len(self.case_shape))),
                _concat_or_empty(res["scores"], (0,)),
                _concat_or_empty(res["labels"], (0,)),
                _concat_or_empty(res["weights"], (0,)),
            )
            self._concat_cache[name] = cat
        return cat

    def model_candidates(self, name: Hashable) -> Tuple[np.ndarray, ...]:
        """The stream's ``(boxes, scores, labels, weights)`` that enter its
        model-level NMS: top-k, clipped to the case, small boxes and scores
        at or below the threshold removed."""
        p = self.parameters
        boxes, probs, labels, weights = self._concat(name)
        idx = np.argsort(-probs, kind="stable")[: p["model_topk"]]
        boxes, probs, labels, weights = boxes[idx], probs[idx], labels[idx], weights[idx]
        boxes = clip_boxes_to_image_np(boxes, self.case_shape)
        keep = np.all(box_size_np(boxes) >= p["remove_small_boxes"], axis=-1)
        keep &= probs > p["model_score_thresh"]
        return boxes[keep], probs[keep], labels[keep], weights[keep]

    # parameters that change the per-model post-processing output: the cache key
    _MODEL_PARAM_KEYS = (
        "model_topk",
        "remove_small_boxes",
        "model_score_thresh",
        "model_nms_fn",
        "model_iou",
        "model_detections_per_image",
    )

    def _model_key(self, name: Hashable) -> Tuple:
        return (name,) + tuple(self.parameters[k] for k in self._MODEL_PARAM_KEYS)

    def process_model(self, name: Hashable) -> Tuple[np.ndarray, ...]:
        p = self.parameters
        key = self._model_key(name)
        hit = self._model_post_cache.get(key)
        if hit is not None:
            return hit
        with trace.span("ensemble.model_nms"):
            boxes, probs, labels, weights = out = self.model_candidates(name)
            if len(boxes):
                nms_fn = MODEL_NMS_FNS[p["model_nms_fn"]]
                keep_idx = nms_fn(boxes, probs, labels, weights, p["model_iou"])
                keep_idx = keep_idx[: p["model_detections_per_image"]]
                out = (boxes[keep_idx], probs[keep_idx], labels[keep_idx], weights[keep_idx])
        self._model_post_cache[key] = out
        return out

    def process_models_on_device(self) -> None:
        """:meth:`process_model` of every stream not memoised, their NMS in
        one batched launch on the ensembler's device; fills the memo."""
        p = self.parameters
        todo = [(name, self._model_key(name)) for name in self.model_results]
        todo = [(name, key) for name, key in todo if key not in self._model_post_cache]
        if not todo:
            return
        with trace.span("ensemble.model_nms"):
            rank = MODEL_NMS_KEYS[p["model_nms_fn"]]
            cands = [self.model_candidates(name) for name, _ in todo]
            kept = batched_model_nms_device(
                [(b, rank(s, w), l) for b, s, l, w in cands], p["model_iou"],
                p["model_detections_per_image"], self.device)
            for (_, key), cand, keep_idx in zip(todo, cands, kept):
                self._model_post_cache[key] = (
                    tuple(a[keep_idx] for a in cand) if len(cand[0]) else cand)
            trace.count("ensemble.streams_on_card", len(todo))

    def _finish(self, boxes, probs, labels, weights, n_exp, fn) -> Dict[str, np.ndarray]:
        p = self.parameters
        with trace.span("ensemble.cluster"):
            b, s, l = fn(
                boxes, probs, labels, weights,
                iou_thresh=p["ensemble_iou"],
                n_exp_preds=n_exp,
                score_thresh=p["ensemble_score_thresh"],
                device=self.device,
            )
        order = np.argsort(-s, kind="stable")
        return {
            "pred_boxes": b[order],
            "pred_scores": s[order],
            "pred_labels": l[order].astype(np.int64),
        }

    def get_case_result(self) -> Dict[str, np.ndarray]:
        """Consolidate all models -> final case detections."""
        with trace.span("ensemble.consolidate"):
            return self._consolidate()

    def _consolidate(self) -> Dict[str, np.ndarray]:
        p = self.parameters
        if _use_device_model_nms(self.device):
            self.process_models_on_device()
        per_model = [self.process_model(name) for name in self.model_results]
        if not per_model:
            return _empty_result(len(self.case_shape))
        boxes, probs, labels, weights = (
            np.concatenate([m[i] for m in per_model]) for i in range(4))

        idx = np.argsort(-probs, kind="stable")[: p["ensemble_topk"]]
        boxes, probs, labels, weights = boxes[idx], probs[idx], labels[idx], weights[idx]
        if len(boxes) == 0:
            return _empty_result(len(self.case_shape))
        n_exp = np.full(len(boxes), len(per_model), dtype=np.float64)
        return self._finish(boxes, probs, labels, weights, n_exp,
                            ENSEMBLE_FNS[p["ensemble_nms_fn"]])

    # ------------------------------------------------------------------
    def save_state(self, target_dir, name: str) -> None:
        """Persist the accumulated (top-k reduced) predictions for sweeps,
        in the JAX package's format: ``<name>_boxes_state.pkl``."""
        p = self.parameters
        compact = {}
        for model in self.model_results:
            boxes, probs, labels, weights = self._concat(model)
            idx = np.argsort(-probs, kind="stable")[: p["model_topk"]]
            compact[model] = {
                "boxes": [boxes[idx]],
                "scores": [probs[idx]],
                "labels": [labels[idx]],
                "weights": [weights[idx]],
            }
        save_pickle(
            {
                "case_shape": self.case_shape,
                "parameters": self.parameters,
                "properties": self.properties,
                "model_results": compact,
                "model_weights": self.model_weights,
            },
            Path(target_dir) / f"{name}_boxes_state.pkl",
        )

    @classmethod
    def from_checkpoint(cls, path, device: Device = None) -> "BoxEnsemblerSelective":
        payload = load_pickle(path)
        obj = cls(
            case_shape=payload["case_shape"],
            parameters=payload["parameters"],
            properties=payload["properties"],
            device=device,
        )
        obj.model_results = payload["model_results"]
        obj.model_weights = payload["model_weights"]
        return obj


class OverlapMap:
    """Per-voxel tile-overlap counter, to estimate the number of *expected*
    predictions per box."""

    def __init__(self, case_shape: Sequence[int]):
        self.map = np.zeros(tuple(int(s) for s in case_shape), dtype=np.float32)

    def add_tile(self, tile_origin: Sequence[int], tile_size: Sequence[int]) -> None:
        sl = tuple(slice(int(o), int(o) + int(p)) for o, p in zip(tile_origin, tile_size))
        self.map[sl] += 1.0

    def mean_overlap_in_boxes(self, boxes: np.ndarray) -> np.ndarray:
        """Mean overlap count inside each box (expected predictions per
        stream); boxes ``(x1, y1, x2, y2[, z1, z2])`` of the map's rank (the
        JAX package reads six coordinates whatever the rank)."""
        out = np.ones(len(boxes), dtype=np.float32)
        shape = self.map.shape
        for i, b in enumerate(boxes):
            bounds = ((b[0], b[2]), (b[1], b[3])) + (((b[4], b[5]),) if len(shape) == 3 else ())
            sl = tuple(
                slice(int(max(0, np.floor(lo))), int(min(s, max(np.ceil(hi), np.floor(lo) + 1))))
                for (lo, hi), s in zip(bounds, shape)
            )
            region = self.map[sl]
            out[i] = float(region.mean()) if region.size else 1.0
        return out


class BoxEnsemblerWBC(BoxEnsemblerSelective):
    """Classic WBC ensembler: no per-model NMS. Every (model x TTA) stream's
    tile predictions go straight into one whole-case weighted box clustering,
    whose expected-prediction count comes from the tile :class:`OverlapMap`
    times the number of streams. Box-in-tile weights are Gaussian (per-axis
    scaled normal pdf about the tile center, averaged over axes)."""

    def __init__(self, case_shape, parameters=None, properties=None, device: Device = None):
        super().__init__(case_shape, parameters, properties, device)
        self.overlap_map = OverlapMap(case_shape)
        self._tiles_counted_for: Optional[Hashable] = None

    @staticmethod
    def _get_box_in_tile_weight(centers: np.ndarray, tile_size: Sequence[int]) -> np.ndarray:
        """``norm.pdf(center, loc=ps/2, scale=ps/2*0.8)`` normalized to 1 at
        the tile center, averaged over axes."""
        if len(centers) == 0:
            return np.zeros((0,), dtype=np.float32)
        half = np.asarray(tile_size, dtype=np.float64) / 2.0
        z = (centers - half[None]) / (half[None] * 0.8)
        return np.mean(np.exp(-0.5 * z * z), axis=1).astype(np.float32)

    def process_tile(self, boxes, scores, labels, tile_origin, tile_size):
        # count each tile once (the grid repeats identically per stream)
        if self._tiles_counted_for in (None, self.model_current):
            self._tiles_counted_for = self.model_current
            self.overlap_map.add_tile(tile_origin, tile_size)
        super().process_tile(boxes, scores, labels, tile_origin, tile_size)

    def _consolidate(self) -> Dict[str, np.ndarray]:
        p = self.parameters
        num_streams = max(len(self.model_results), 1)
        streams = [self._concat(name) for name, res in self.model_results.items() if res["boxes"]]
        if not streams:
            return _empty_result(len(self.case_shape))
        boxes, probs, labels, weights = (np.concatenate([s[i] for s in streams]) for i in range(4))

        idx = np.argsort(-probs, kind="stable")[: p["ensemble_topk"]]
        boxes, probs, labels, weights = boxes[idx], probs[idx], labels[idx], weights[idx]
        boxes = clip_boxes_to_image_np(boxes, self.case_shape)
        keep = np.all(box_size_np(boxes) >= p["remove_small_boxes"], axis=-1)
        boxes, probs, labels, weights = boxes[keep], probs[keep], labels[keep], weights[keep]
        if len(boxes) == 0:
            return _empty_result(len(self.case_shape))
        n_exp = self.overlap_map.mean_overlap_in_boxes(boxes) * num_streams
        return self._finish(boxes, probs, labels, weights, n_exp, batched_wbc_ensemble)


class BoxEnsemblerLW(BoxEnsemblerWBC):
    """Classic WBC ensembler with the linear plateau box weight of the
    selective ensembler instead of the Gaussian."""

    _get_box_in_tile_weight = staticmethod(BoxEnsemblerSelective._get_box_in_tile_weight)


class BoxEnsemblerFastest(BoxEnsemblerLW):
    """Fastest (least precise) classic variant: linear box weight, per-stream
    caches truncated to the top ``num_reduced_cache`` scores, and the
    expected-predictions count taken from the GLOBAL overlap-map mean rather
    than per-box region means."""

    num_reduced_cache = 8000

    def process_tile(self, boxes, scores, labels, tile_origin, tile_size):
        super().process_tile(boxes, scores, labels, tile_origin, tile_size)
        res = self.model_results[self.model_current]
        n = sum(len(s) for s in res["scores"])
        if n > 2 * self.num_reduced_cache:
            scores_all = np.concatenate(res["scores"])
            idx = np.argsort(-scores_all, kind="stable")[: self.num_reduced_cache]
            for key, cat in (
                ("boxes", np.concatenate(res["boxes"])),
                ("scores", scores_all),
                ("labels", np.concatenate(res["labels"])),
                ("weights", np.concatenate(res["weights"])),
            ):
                res[key] = [cat[idx]]

    def get_case_result(self) -> Dict[str, np.ndarray]:
        mean = float(self.overlap_map.map.mean()) or 1.0
        # the per-box overlap estimate becomes the global mean
        self.overlap_map.mean_overlap_in_boxes = (  # type: ignore[method-assign]
            lambda boxes, _m=mean: np.full(len(boxes), _m, dtype=np.float32)
        )
        return super().get_case_result()


# name -> class, as the JAX package's ensembler registry
BOX_ENSEMBLERS = {
    "BoxEnsemblerSelective": BoxEnsemblerSelective,
    "BoxEnsembler": BoxEnsemblerWBC,
    "BoxEnsemblerWBC": BoxEnsemblerWBC,
    "BoxEnsemblerLW": BoxEnsemblerLW,
    "BoxEnsemblerFastest": BoxEnsemblerFastest,
}


class SegmentationEnsembler:
    """Sliding-window softmax accumulation with Gaussian tile weighting
    (counterpart of the JAX package's ``SegmentationEnsembler``). The
    accumulator ``[C, *case]`` and the weight map, float32, live on
    ``device``; tiles are added in the order they come, each as
    ``probs * w`` and then ``w``."""

    def __init__(self, case_shape: Sequence[int], num_classes: int, device: Device = None):
        self.case_shape = tuple(int(s) for s in case_shape)
        self.num_classes = num_classes
        self.device = torch.device("cpu" if device is None else device)
        self.accum = torch.zeros((num_classes, *self.case_shape), dtype=torch.float32,
                                 device=self.device)
        self.weight = torch.zeros(self.case_shape, dtype=torch.float32, device=self.device)
        self._tile_weight_cache: Dict[tuple, torch.Tensor] = {}

    @classmethod
    def sweep_parameters(cls) -> Tuple[Dict[str, Any], Dict[str, Sequence[Any]]]:
        """No sweepable post-processing parameters: the sweep tunes boxes only."""
        return {}, {}

    def process_tile(self, probs, tile_origin: Sequence[int]) -> None:
        """probs: ``[*patch, C]`` softmax probabilities (a tensor, moved to the
        ensembler's device if it is elsewhere, or a NumPy array)."""
        probs = torch.as_tensor(probs).to(self.device, torch.float32)
        key = tuple(probs.shape[:-1])
        w = self._tile_weight_cache.get(key)
        if w is None:
            w = self._tile_weight_cache[key] = torch.from_numpy(tile_weight_map(key)).to(self.device)
        sl = tuple(slice(int(o), int(o) + p) for o, p in zip(tile_origin, key))
        self.accum[(slice(None),) + sl] += probs.movedim(-1, 0) * w[None]
        self.weight[sl] += w

    def get_case_result(self) -> np.ndarray:
        """The argmax class per voxel, ``[*case]`` int16 on the host."""
        norm = self.accum / torch.clamp(self.weight[None], min=1e-8)
        return torch.argmax(norm, dim=0).to(torch.int16).cpu().numpy()
