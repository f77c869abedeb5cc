"""Plain whole-case consolidation of tiled box predictions, NumPy float64:
nnDetection's ``BoxEnsemblerSelective`` (``nndet/inference/ensembler/
detection.py``) as ``nndetection_tpu_torch/inference/ensembler.py`` states
it, frozen here.

Per tile the boxes are weighted by their centre's distance from the tile
centre and moved into case coordinates; per stream (model x flip) the top
``model_topk`` by score are clipped to the case, small boxes and low scores
dropped and a greedy NMS ranked by score x weight keeps at most
``model_detections_per_image``; over the streams the top ``ensemble_topk``
go through a per-class weighted box clustering (WBC).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULTS = {
    "model_iou": 0.1, "model_nms_fn": "weighted_nms", "model_score_thresh": 0.0,
    "model_topk": 1000, "model_detections_per_image": 100, "ensemble_iou": 0.5,
    "ensemble_nms_fn": "wbc", "ensemble_topk": 1000, "remove_small_boxes": 1e-2,
    "ensemble_score_thresh": 0.0,
}


def corners(boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    if boxes.shape[-1] == 4:
        return boxes[..., [0, 1]], boxes[..., [2, 3]]
    return boxes[..., [0, 1, 4]], boxes[..., [2, 3, 5]]


def from_corners(mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
    if mins.shape[-1] == 2:
        return np.stack([mins[..., 0], mins[..., 1], maxs[..., 0], maxs[..., 1]], -1)
    return np.stack([mins[..., 0], mins[..., 1], maxs[..., 0], maxs[..., 1],
                     mins[..., 2], maxs[..., 2]], -1)


def axis_vector(vec, dim: int) -> np.ndarray:
    """``(a0, a1[, a2])`` in the box layout ``(a0, a1, a0, a1[, a2, a2])``."""
    out = [vec[0], vec[1], vec[0], vec[1]]
    return np.asarray(out + ([vec[2], vec[2]] if dim == 3 else []))


def iou(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    lo1, hi1 = corners(b1.astype(np.float64))
    lo2, hi2 = corners(b2.astype(np.float64))
    inter = np.prod(np.clip(np.minimum(hi1[:, None], hi2[None]) -
                            np.maximum(lo1[:, None], lo2[None]), 0, None), axis=-1)
    a1, a2 = np.prod(hi1 - lo1, axis=-1), np.prod(hi2 - lo2, axis=-1)
    return inter / (a1[:, None] + a2[None] - inter)


def nms(boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray, thr: float) -> np.ndarray:
    """Class-batched greedy NMS: kept indices, best first, equal scores in
    index order."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    off = labels.astype(np.float64) * (boxes.max() + 1)
    lo, hi = corners(boxes.astype(np.float64))
    shifted = from_corners(lo + off[:, None], hi + off[:, None])
    order = np.argsort(-scores, kind="stable")
    ious = iou(shifted[order], shifted[order])
    suppressed = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if suppressed[i]:
            continue
        keep.append(order[i])
        suppressed |= ious[i] > thr
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def wbc(boxes, scores, weights, n_exp, thr, score_thresh=0.0):
    """Single-class weighted box clustering, clusters in the order formed."""
    if len(boxes) == 0:
        return np.zeros((0, boxes.shape[-1])), np.zeros((0,))
    boxes, scores, w = (a.astype(np.float64) for a in (boxes, scores, weights))
    ious = iou(boxes, boxes)
    pool = np.argsort(-scores, kind="stable")
    out_b, out_s = [], []
    while pool.size:
        seed = pool[0]
        m = ious[seed][pool] > thr
        cluster = pool[m]
        if len(cluster):
            msw = ious[seed][cluster] * w[cluster]
            ms = msw * scores[cluster]
            missing = max(0.0, float(np.mean(n_exp[cluster])) - len(cluster))
            score = ms.sum() / (msw.sum() + missing * msw.mean())
            if score > score_thresh:
                out_b.append((boxes[cluster] * ms[:, None]).sum(0) / ms.sum())
                out_s.append(score)
        m[0] = True
        pool = pool[~m]
    if not out_b:
        return np.zeros((0, boxes.shape[-1])), np.zeros((0,))
    return np.stack(out_b), np.asarray(out_s)


def tile_weight(boxes: np.ndarray, tile_size: Sequence[int]) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros((0,), np.float32)
    lo, hi = corners(boxes)
    centers = (lo + hi) * 0.5
    tc = np.asarray(tile_size, np.float64) / 2.0
    dist = np.linalg.norm(centers - tc[None], axis=1)
    return (1.0 - np.clip(dist / np.linalg.norm(tc) - 0.5, 0, None)).astype(np.float32)


class Selective:
    """Collects the streams' tiles, then :meth:`result`."""

    def __init__(self, case_shape: Sequence[int], parameters: Dict = None):
        self.case_shape = tuple(int(s) for s in case_shape)
        self.p = dict(DEFAULTS, **(parameters or {}))
        self.streams: Dict[str, List[Tuple[np.ndarray, ...]]] = {}

    def add_tile(self, stream, boxes, scores, labels, origin, tile_size) -> None:
        dim = len(self.case_shape)
        w = tile_weight(boxes, tile_size)
        if len(boxes):
            boxes = boxes + axis_vector(np.asarray(origin, np.float32), dim)[None]
        self.streams.setdefault(stream, []).append((
            np.asarray(boxes, np.float32).reshape(-1, 2 * dim),
            np.asarray(scores, np.float32).reshape(-1),
            np.asarray(labels, np.int64).reshape(-1), w.reshape(-1)))

    def _stream(self, tiles):
        p = self.p
        boxes, probs, labels, weights = (np.concatenate([t[i] for t in tiles]) for i in range(4))
        idx = np.argsort(-probs, kind="stable")[: p["model_topk"]]
        boxes, probs, labels, weights = boxes[idx], probs[idx], labels[idx], weights[idx]
        lo, hi = corners(boxes)
        bounds = np.asarray(self.case_shape, boxes.dtype)
        boxes = from_corners(np.clip(lo, 0, bounds), np.clip(hi, 0, bounds))
        lo, hi = corners(boxes)
        keep = np.all(hi - lo >= p["remove_small_boxes"], axis=-1) & (probs > p["model_score_thresh"])
        boxes, probs, labels, weights = boxes[keep], probs[keep], labels[keep], weights[keep]
        if len(boxes):
            k = nms(boxes, probs * weights, labels, p["model_iou"])[: p["model_detections_per_image"]]
            boxes, probs, labels, weights = boxes[k], probs[k], labels[k], weights[k]
        return boxes, probs, labels, weights

    def result(self) -> Dict[str, np.ndarray]:
        p = self.p
        dim = len(self.case_shape)
        per = [self._stream(t) for t in self.streams.values()]
        boxes, probs, labels, weights = (np.concatenate([m[i] for m in per]) for i in range(4))
        idx = np.argsort(-probs, kind="stable")[: p["ensemble_topk"]]
        boxes, probs, labels, weights = boxes[idx], probs[idx], labels[idx], weights[idx]
        n_exp = np.full(len(boxes), len(per), np.float64)
        ob, os_, ol = [], [], []
        for c in np.unique(labels):
            m = labels == c
            b, s = wbc(boxes[m], probs[m], weights[m], n_exp[m], p["ensemble_iou"],
                       p["ensemble_score_thresh"])
            ob.append(b)
            os_.append(s)
            ol.append(np.full(len(s), c))
        if not ob:
            return {"pred_boxes": np.zeros((0, 2 * dim)), "pred_scores": np.zeros((0,)),
                    "pred_labels": np.zeros((0,), np.int64)}
        b, s, l = np.concatenate(ob), np.concatenate(os_), np.concatenate(ol)
        order = np.argsort(-s, kind="stable")
        return {"pred_boxes": b[order], "pred_scores": s[order],
                "pred_labels": l[order].astype(np.int64)}
