"""Truncated greedy 3D NMS over a batch of images: the counterpart of
``nndetection_tpu/ops/pallas_ops.py::nms_topk_pallas``.

:func:`nms_topk` launches the CUDA kernel of ``csrc/nms_topk.cu`` (one thread
block per image) for CUDA tensors and runs :func:`nms_topk_plain` for CPU
tensors. Both compute, for each image, ``max_out`` steps of: select the
highest remaining score (lowest index among ties), drop it and every box
whose IoU with it is strictly greater than the threshold.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from nndetection_tpu_torch.ops import LAUNCHES, _build

# dynamic shared memory of one block holds the scores: 227 KB / 4 B
MAX_BOXES_CUDA = 232448 // 4

_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load().nms_topk_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,              # boxes, scores
            ctypes.c_int, ctypes.c_int, ctypes.c_int,      # images, n, max_out
            ctypes.c_float,                                # iou threshold
            ctypes.c_void_p, ctypes.c_void_p,              # out idx, out valid
            ctypes.c_void_p,                               # stream
        ]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def nms_topk_plain(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel.

    Args:
        boxes: ``[I, N, 6]`` float32
        scores: ``[I, N]`` float32, ``-inf`` where a box is not valid
        max_out: steps to run, ``<= N``

    Returns ``(idx [I, max_out] int32, valid [I, max_out] bool)``; a step
    with no box left gives index 0, invalid.
    """
    n_img = scores.shape[0]
    s = scores.clone()
    x1, y1, x2, y2, z1, z2 = boxes.unbind(-1)
    vol = ((x2 - x1) * (y2 - y1)) * (z2 - z1)
    rows = torch.arange(n_img, device=boxes.device)
    idx = torch.zeros((n_img, max_out), dtype=torch.int32, device=boxes.device)
    valid = torch.zeros((n_img, max_out), dtype=torch.bool, device=boxes.device)
    neg_inf = torch.tensor(float("-inf"), device=boxes.device)
    zero = torch.zeros((), device=boxes.device)
    # compared in float32, as the kernel and the Pallas version do
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    for step in range(max_out):
        k = torch.argmax(s, dim=1)  # first index of the max
        alive = s[rows, k] > float("-inf")
        sel = boxes[rows, k][:, :, None]  # [I, 6, 1]
        ix = torch.maximum(torch.minimum(sel[:, 2], x2) - torch.maximum(sel[:, 0], x1), zero)
        iy = torch.maximum(torch.minimum(sel[:, 3], y2) - torch.maximum(sel[:, 1], y1), zero)
        iz = torch.maximum(torch.minimum(sel[:, 5], z2) - torch.maximum(sel[:, 4], z1), zero)
        inter = (ix * iy) * iz
        vol_k = vol[rows, k][:, None]
        union = torch.clamp((vol_k + vol) - inter, min=1e-12)
        drop = inter / union > thr
        drop[rows, k] = True
        s = torch.where(alive[:, None] & drop, neg_inf, s)
        idx[:, step] = torch.where(alive, k, 0).to(torch.int32)
        valid[:, step] = alive
    return idx, valid


def _nms_topk_cuda(boxes, scores, iou_threshold, max_out):
    n_img, n = scores.shape
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_topk takes float32, got {boxes.dtype}, {scores.dtype}")
    if boxes.shape != (n_img, n, 6):
        raise ValueError(f"boxes {tuple(boxes.shape)} do not match scores {tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_topk takes contiguous boxes and scores")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores on different devices")
    if n > MAX_BOXES_CUDA:
        raise ValueError(f"nms_topk holds at most {MAX_BOXES_CUDA} boxes per image, got {n}")
    idx = torch.empty((n_img, max_out), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((n_img, max_out), dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = _kernel()(
            boxes.data_ptr(), scores.data_ptr(), n_img, n, max_out,
            float(iou_threshold), idx.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "nms_topk_launch")
    LAUNCHES["nms_topk"] += 1
    return idx, valid.bool()


def nms_topk(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS keeping at most ``max_out`` boxes per image.

    Args:
        boxes: ``[I, N, 6]`` float32
        scores: ``[I, N]`` float32 with ``-inf`` where not valid
        max_out: number of survivors to emit per image; steps beyond ``N``
            are padded with index 0, invalid

    Returns ``(idx [I, max_out] int64, valid [I, max_out] bool)`` in
    descending-score order; indices are clipped into ``[0, N-1]``.
    """
    n_img, n = scores.shape
    steps = min(max_out, n)
    if steps == 0 or n_img == 0:
        idx = torch.zeros((n_img, steps), dtype=torch.int32, device=scores.device)
        valid = torch.zeros((n_img, steps), dtype=torch.bool, device=scores.device)
    elif scores.device.type == "cpu":
        idx, valid = nms_topk_plain(boxes, scores, iou_threshold, steps)
    elif scores.device.type == "cuda":
        idx, valid = _nms_topk_cuda(boxes, scores, iou_threshold, steps)
    else:
        raise NotImplementedError(f"nms_topk has no kernel for {scores.device}")
    idx = idx.long().clamp_(0, max(n - 1, 0))
    if max_out > steps:
        pad = max_out - steps
        idx = torch.cat([idx, idx.new_zeros((n_img, pad))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((n_img, pad))], dim=1)
    return idx, valid
