"""ctypes bindings to the port's host library (``csrc/nndet_host.cpp``,
counterpart of :mod:`nndetection_tpu.ops.native`).

:func:`nndetection_tpu_torch.ops._build.load_host` compiles the library with
the host C++ compiler at first use. The entry points return ``None`` only
when no C++ compiler is found; then the callers run their NumPy loops, as
the JAX package does without its library. A failed compile or ``dlopen``
raises. :data:`NATIVE_CALLS` counts the library's calls per C entry point.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import numpy as np

from nndetection_tpu_torch.ops import _build

NATIVE_CALLS: Counter = Counter()

_bound: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _bound
    if _bound is None:
        lib = _build.load_host()
        if lib is None:
            return None
        c_d = ctypes.POINTER(ctypes.c_double)
        c_i64 = ctypes.POINTER(ctypes.c_int64)
        c_u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.iou_matrix_3d.argtypes = [c_d, ctypes.c_int64, c_d, ctypes.c_int64, c_d]
        lib.iou_matrix_3d.restype = None
        lib.nms_3d.argtypes = [c_d, c_d, ctypes.c_int64, ctypes.c_double, c_i64]
        lib.nms_3d.restype = ctypes.c_int64
        lib.wbc_3d.argtypes = [
            c_d, c_d, c_d, c_d, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, c_d, c_d,
        ]
        lib.wbc_3d.restype = ctypes.c_int64
        lib.coco_match.argtypes = [
            c_d, ctypes.c_int64, ctypes.c_int64, c_u8, c_d, ctypes.c_int64, c_d, c_d, c_d,
        ]
        lib.coco_match.restype = None
        _bound = lib
    return _bound


def available() -> bool:
    """Whether the host library is in use (builds it on first call)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype=ctypes.c_double):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def iou_matrix_native(boxes1: np.ndarray, boxes2: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None or boxes1.shape[-1] != 6:
        return None
    b1 = np.ascontiguousarray(boxes1, dtype=np.float64)
    b2 = np.ascontiguousarray(boxes2, dtype=np.float64)
    out = np.empty((len(b1), len(b2)), dtype=np.float64)
    NATIVE_CALLS["iou_matrix_3d"] += 1
    lib.iou_matrix_3d(_ptr(b1), len(b1), _ptr(b2), len(b2), _ptr(out))
    return out


def nms_native(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None or boxes.shape[-1] != 6 or len(boxes) == 0:
        return None
    b = np.ascontiguousarray(boxes, dtype=np.float64)
    s = np.ascontiguousarray(scores, dtype=np.float64)
    keep = np.empty(len(b), dtype=np.int64)
    NATIVE_CALLS["nms_3d"] += 1
    n = lib.nms_3d(_ptr(b), _ptr(s), len(b), float(iou_threshold), _ptr(keep, ctypes.c_int64))
    return keep[:n].copy()


def wbc_native(
    boxes: np.ndarray,
    scores: np.ndarray,
    weights: np.ndarray,
    n_exp_preds: np.ndarray,
    iou_thresh: float,
    score_thresh: float = 0.0,
    use_area: bool = False,
    missing_weight: float = 1.0,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None or boxes.shape[-1] != 6:
        return None
    if len(boxes) == 0:
        return np.zeros((0, 6)), np.zeros((0,))
    b = np.ascontiguousarray(boxes, dtype=np.float64)
    s = np.ascontiguousarray(scores, dtype=np.float64)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    ne = np.ascontiguousarray(n_exp_preds, dtype=np.float64)
    ob = np.empty_like(b)
    os_ = np.empty_like(s)
    NATIVE_CALLS["wbc_3d"] += 1
    n = lib.wbc_3d(_ptr(b), _ptr(s), _ptr(w), _ptr(ne), len(b), float(iou_thresh),
                   float(score_thresh), float(missing_weight), int(use_area), _ptr(ob), _ptr(os_))
    return ob[:n].copy(), os_[:n].copy()


def coco_match_native(
    ious: np.ndarray, gt_ignore: np.ndarray, thresholds: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    iou = np.ascontiguousarray(ious, dtype=np.float64)
    gi = np.ascontiguousarray(gt_ignore, dtype=np.uint8)
    th = np.ascontiguousarray(thresholds, dtype=np.float64)
    n_pred, n_gt = iou.shape
    n_thr = len(th)
    dtm = np.empty((n_thr, n_pred), dtype=np.float64)
    gtm = np.empty((n_thr, n_gt), dtype=np.float64)
    dti = np.empty((n_thr, n_pred), dtype=np.float64)
    NATIVE_CALLS["coco_match"] += 1
    lib.coco_match(_ptr(iou), n_pred, n_gt, _ptr(gi, ctypes.c_uint8), _ptr(th), n_thr,
                   _ptr(dtm), _ptr(gtm), _ptr(dti))
    return dtm, gtm, dti
