"""The cluster loop of weighted box clustering: the counterpart of the
``lax.while_loop`` of ``nndetection_tpu/core/boxes/wbc.py::wbc``.

:func:`wbc_cluster` launches the CUDA kernel of ``csrc/wbc_cluster.cu`` (one
block per class) for CUDA tensors and runs :func:`wbc_cluster_plain` for CPU
tensors. Both take the IoU matrix of all boxes and cluster each class on its
own; the output of class ``c`` is row ``c`` of ``[C, N]`` arrays, clusters
in the order they formed, padded with zeros and ``valid = False``. The plain
version sums in the kernel's order, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from nndetection_tpu_torch.ops import LAUNCHES, _build

# threads of the kernel's block (one block per class)
THREADS = 256
# the scores of the remaining boxes in one block's shared memory, beside the
# kernel's static arrays
MAX_BOXES_CUDA = (232448 - 2048) // 4

_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load().wbc_cluster_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ious, boxes, scores
            ctypes.c_void_p, ctypes.c_void_p,                   # weights, n_exp
            ctypes.c_void_p, ctypes.c_void_p,                   # labels, valid
            ctypes.c_int, ctypes.c_int,                         # n, classes
            ctypes.c_float, ctypes.c_float, ctypes.c_float,     # iou, score thr, missing w
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out boxes, scores, valid
            ctypes.c_void_p,                                    # stream
        ]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _kernel_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Column sums of ``x [N, K]`` in the kernel's order, so that the float32
    result has the kernel's bits: thread ``t`` of the 256 adds rows ``t``,
    ``t + 256``, ... in order, each warp folds its 32 partial sums by the
    shuffle-down tree (a lane past the warp's end adds its own value), and
    thread 0 adds the 8 warp sums in order."""
    n, k = x.shape
    rows = -(-n // THREADS)
    x = torch.cat([x, x.new_zeros((rows * THREADS - n, k))]).view(rows, THREADS, k)
    acc = x.new_zeros((THREADS, k))
    for r in range(rows):
        acc = acc + x[r]
    lanes = acc.view(THREADS // 32, 32, k)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + torch.cat([lanes[:, off:], lanes[:, 32 - off:]], dim=1)
    total = lanes[0, 0]
    for w in range(1, THREADS // 32):
        total = total + lanes[w, 0]
    return total


def wbc_cluster_plain(
    ious, boxes, scores, weights, n_exp, labels, valid, num_classes,
    iou_thresh, score_thresh, missing_weight=1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: a Python loop over the clusters
    of each class, float32, with the kernel's order of summation (a box
    outside the cluster adds an exact zero). Arguments and outputs as
    :func:`wbc_cluster`."""
    n, dev = scores.shape[0], scores.device
    f32 = dict(dtype=torch.float32, device=dev)
    out_boxes = torch.zeros((num_classes, n, 6), **f32)
    out_scores = torch.zeros((num_classes, n), **f32)
    out_valid = torch.zeros((num_classes, n), dtype=torch.bool, device=dev)
    iou_thr = torch.tensor(iou_thresh, **f32)
    score_thr = torch.tensor(score_thresh, **f32)
    mw = torch.tensor(missing_weight, **f32)
    one, tiny = torch.tensor(1.0, **f32), torch.tensor(1e-12, **f32)
    for c in range(num_classes):
        remaining = valid & (labels == c) & torch.isfinite(scores)
        count = 0
        while bool(remaining.any()):
            seed = int(torch.argmax(torch.where(remaining, scores, float("-inf"))))
            cluster = remaining & (ious[seed] > iou_thr)
            remaining = remaining & ~cluster
            remaining[seed] = False  # also when outside its own cluster
            cm = cluster.float()
            msw = ious[seed] * weights * cm
            ms = msw * scores
            sums = _kernel_order_sum(torch.stack(
                [cm, n_exp * cm, msw, ms] + [boxes[:, d] * ms for d in range(6)], dim=1))
            n_found, msw_sum, ms_sum = sums[0], sums[2], sums[3]
            n_expected = sums[1] / torch.maximum(n_found, one)
            n_missing = torch.clamp(n_expected - n_found, min=0.0)
            denom = msw_sum + (n_missing * (msw_sum / torch.maximum(n_found, one))) * mw
            new_score = ms_sum / torch.maximum(denom, tiny)
            if bool(new_score > score_thr):
                out_boxes[c, count] = sums[4:] / torch.maximum(ms_sum, tiny)
                out_scores[c, count] = new_score
                out_valid[c, count] = True
                count += 1
    return out_boxes, out_scores, out_valid


def _wbc_cluster_cuda(ious, boxes, scores, weights, n_exp, labels, valid, num_classes,
                      iou_thresh, score_thresh, missing_weight):
    n = scores.shape[0]
    if n > MAX_BOXES_CUDA:
        raise ValueError(f"wbc_cluster holds at most {MAX_BOXES_CUDA} boxes, got {n}")
    expect = {"ious": (ious, torch.float32, (n, n)), "boxes": (boxes, torch.float32, (n, 6)),
              "scores": (scores, torch.float32, (n,)), "weights": (weights, torch.float32, (n,)),
              "n_exp": (n_exp, torch.float32, (n,)), "labels": (labels, torch.int32, (n,)),
              "valid": (valid, torch.bool, (n,))}
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype:
            raise TypeError(f"wbc_cluster {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"wbc_cluster {name} must be contiguous {shape}, got {tuple(t.shape)}")
        if t.device != scores.device:
            raise ValueError(f"wbc_cluster {name} on {t.device}, scores on {scores.device}")
    dev = scores.device
    out_boxes = torch.empty((num_classes, n, 6), dtype=torch.float32, device=dev)
    out_scores = torch.empty((num_classes, n), dtype=torch.float32, device=dev)
    out_valid = torch.empty((num_classes, n), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = _kernel()(
            ious.data_ptr(), boxes.data_ptr(), scores.data_ptr(), weights.data_ptr(),
            n_exp.data_ptr(), labels.data_ptr(), valid.data_ptr(), n, num_classes,
            float(iou_thresh), float(score_thresh), float(missing_weight),
            out_boxes.data_ptr(), out_scores.data_ptr(), out_valid.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "wbc_cluster_launch")
    LAUNCHES["wbc_cluster"] += 1
    return out_boxes, out_scores, out_valid.bool()


def wbc_cluster(
    ious: torch.Tensor,
    boxes: torch.Tensor,
    scores: torch.Tensor,
    weights: torch.Tensor,
    n_exp: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    num_classes: int,
    iou_thresh: float,
    score_thresh: float,
    missing_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy weighted box clustering of each class.

    Args:
        ious: ``[N, N]`` float32 IoU of the boxes (:func:`iou_matrix`)
        boxes: ``[N, 6]`` float32
        scores, weights, n_exp: ``[N]`` float32 (weights already multiplied
            by the box volume where the caller wants ``use_area``)
        labels: ``[N]`` int32; class ``c`` clusters the boxes of label ``c``
        valid: ``[N]`` bool
        num_classes: classes ``0 .. C-1``

    Returns ``(boxes [C, N, 6], scores [C, N], valid [C, N] bool)``.
    """
    # nothing to cluster needs no launch
    if scores.shape[0] == 0 or num_classes == 0 or scores.device.type == "cpu":
        return wbc_cluster_plain(ious, boxes, scores, weights, n_exp, labels, valid,
                                 num_classes, iou_thresh, score_thresh, missing_weight)
    if scores.device.type == "cuda":
        return _wbc_cluster_cuda(ious, boxes, scores, weights, n_exp, labels, valid,
                                 num_classes, iou_thresh, score_thresh, missing_weight)
    raise NotImplementedError(f"wbc_cluster has no kernel for {scores.device}")
