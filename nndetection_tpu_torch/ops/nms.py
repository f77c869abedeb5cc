"""Truncated greedy NMS over a batch of images: the counterpart of
``nndetection_tpu/ops/pallas_ops.py::nms_topk_pallas``. The kernel takes 3D
boxes; :func:`nms_topk` lifts 2D boxes to unit depth in front of it and of
the plain version (:func:`nndetection_tpu_torch.ops.lift_2d`).

:func:`nms_topk` launches the CUDA kernel of ``csrc/nms_topk.cu`` (one thread
block per image) for CUDA tensors and runs :func:`nms_topk_plain` for CPU
tensors. Both compute, for each image, ``max_out`` steps of: select the
highest remaining score (lowest index among ties), drop it and every box
whose IoU with it is strictly greater than the threshold.

The kernel sorts each image's candidates once and walks them in that order,
32 at a time; :func:`plan_nms_topk` sizes its sort and decides whether its
scratch (the sort keys and the selected boxes' references) sits in shared
memory or, for large N, in a global workspace.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from nndetection_tpu_torch.ops import LAUNCHES, _build, lift_2d

# dynamic shared memory one block may opt into on the H100 (227 KB)
SMEM_MAX = 232_448

_launch_fn = None


@dataclass(frozen=True)
class NmsPlan:
    """How the kernel runs over ``n`` boxes per image for ``max_out`` steps:
    the ``n_pad`` keys (a power of two) the sort runs over, the dynamic
    shared memory in bytes, and ``ws_words``, the 8-byte words of global
    workspace per image that hold the scratch (0: it sits in shared
    memory)."""

    n: int
    max_out: int
    n_pad: int
    smem_bytes: int
    ws_words: int


@functools.lru_cache(maxsize=None)
def plan_nms_topk(n: int, max_out: int, smem_bytes: int = SMEM_MAX) -> NmsPlan:
    """The kernel's launch for ``n`` boxes per image and ``max_out`` steps on
    a card whose blocks may take ``smem_bytes`` of shared memory. The sort
    runs over ``n`` padded to a power of two, at least the 64 keys a warp
    sorts in registers (``kSeg`` of ``csrc/nms_topk.cu``). The scratch, 8 B
    per padded key and 4 B per selection (``min(max_out, n)`` of them), sits
    in shared memory behind the kernel's header (``kHeaderWords``) where it
    fits, else in a global workspace of ``ws_words`` per image."""
    if n < 1 or max_out < 1 or n > 1 << 30:
        raise ValueError(f"nms_topk plan needs 1 <= n <= 2**30 and max_out >= 1, got {n}, {max_out}")
    geo = _build.constants("nms_topk.cu")
    n_pad = max(geo["kSeg"], 1 << (n - 1).bit_length())
    header = 4 * geo["kHeaderWords"]
    s_cap = min(max_out, n)
    on_chip = header + 8 * n_pad + 4 * s_cap
    if on_chip <= smem_bytes:
        return NmsPlan(n, max_out, n_pad, on_chip, 0)
    return NmsPlan(n, max_out, n_pad, header, n_pad + -(-s_cap // 2))


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load().nms_topk_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,                  # boxes, scores
            ctypes.c_int, ctypes.c_int, ctypes.c_int,          # images, n, n_pad
            ctypes.c_int, ctypes.c_float,                      # max_out, iou threshold
            ctypes.c_void_p, ctypes.c_longlong,                # workspace, its words per image
            ctypes.c_int,                                      # smem bytes
            ctypes.c_void_p, ctypes.c_void_p,                  # out idx, out valid
            ctypes.c_void_p, ctypes.c_int,                     # stream, device
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
    """The kernel over ``max_out`` steps (any number: steps with no box
    alive give index 0, invalid); returns ``(idx int64, valid bool)``."""
    n_img, n = scores.shape
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_topk takes float32, got {boxes.dtype}, {scores.dtype}")
    if boxes.shape != (n_img, n, 6):
        raise ValueError(f"boxes {tuple(boxes.shape)} do not match scores {tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_topk takes contiguous boxes and scores")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores on different devices")
    plan = plan_nms_topk(n, max_out)
    dev = boxes.device
    idx = torch.empty((n_img, max_out), dtype=torch.int64, device=dev)
    valid = torch.empty((n_img, max_out), dtype=torch.bool, device=dev)
    # large N only: the scratch in global memory, one slice per image
    ws = (torch.empty((n_img, plan.ws_words), dtype=torch.int64, device=dev)
          if plan.ws_words else None)
    err = _kernel()(
        boxes.data_ptr(), scores.data_ptr(), n_img, n, plan.n_pad, max_out,
        float(iou_threshold), ws.data_ptr() if ws is not None else None, plan.ws_words,
        plan.smem_bytes, idx.data_ptr(), valid.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index), dev.index,
    )
    _build.check(err, "nms_topk_launch")
    LAUNCHES["nms_topk"] += 1
    return idx, valid


def nms_topk(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_out: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS keeping at most ``max_out`` boxes per image.

    Args:
        boxes: ``[I, N, 6]`` float32, or ``[I, N, 4]`` (2D), lifted to unit
            depth for the kernel or its plain version
        scores: ``[I, N]`` float32 with ``-inf`` where not valid
        max_out: number of survivors to emit per image; steps beyond ``N``
            are padded with index 0, invalid

    Returns ``(idx [I, max_out] int64, valid [I, max_out] bool)`` in
    descending-score order; indices are clipped into ``[0, N-1]``.
    """
    boxes = lift_2d(boxes)
    n_img, n = scores.shape
    steps = min(max_out, n)
    if steps == 0 or n_img == 0:
        idx = torch.zeros((n_img, max_out), dtype=torch.int64, device=scores.device)
        valid = torch.zeros((n_img, max_out), dtype=torch.bool, device=scores.device)
        return idx, valid
    if scores.device.type == "cuda":
        # the kernel writes int64 indices in [0, N-1] and pads past N itself
        return _nms_topk_cuda(boxes, scores, iou_threshold, max_out)
    if scores.device.type != "cpu":
        raise NotImplementedError(f"nms_topk has no kernel for {scores.device}")
    idx, valid = nms_topk_plain(boxes, scores, iou_threshold, steps)
    idx = idx.long().clamp_(0, max(n - 1, 0))
    if max_out > steps:
        pad = max_out - steps
        idx = torch.cat([idx, idx.new_zeros((n_img, pad))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((n_img, pad))], dim=1)
    return idx, valid
