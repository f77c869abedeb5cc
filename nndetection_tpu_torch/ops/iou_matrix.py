"""Pairwise 3D IoU matrix: the counterpart of
``nndetection_tpu/ops/pallas_ops.py::iou_matrix_pallas``.

:func:`iou_matrix` launches the CUDA kernel of ``csrc/iou_matrix.cu`` for
CUDA tensors and runs :func:`iou_matrix_plain` for CPU tensors. Both compute
``inter / max(union, 1e-12)`` in float32 in the Pallas kernel's order, so a
pair of zero-volume boxes has IoU 0 (``core/boxes/ops.py::box_iou`` of the
JAX package gives NaN there).
"""
from __future__ import annotations

import ctypes

import torch

from nndetection_tpu_torch.ops import LAUNCHES, _build

_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load().iou_matrix_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # boxes1, boxes2
            ctypes.c_int, ctypes.c_int,        # n, m
            ctypes.c_void_p, ctypes.c_void_p,  # out, stream
        ]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _volume(b: torch.Tensor) -> torch.Tensor:
    return ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])) * (b[:, 5] - b[:, 4])


def iou_matrix_plain(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[N, 6] x [M, 6] -> [N, M]``
    float32, in the kernel's order of operations."""
    b1, b2 = boxes1.float(), boxes2.float()
    zero = torch.zeros((), device=b1.device)

    def overlap(lo, hi):
        return torch.maximum(torch.minimum(b1[:, hi, None], b2[None, :, hi])
                             - torch.maximum(b1[:, lo, None], b2[None, :, lo]), zero)

    inter = (overlap(0, 2) * overlap(1, 3)) * overlap(4, 5)
    union = (_volume(b1)[:, None] + _volume(b2)[None, :]) - inter
    return inter / torch.clamp(union, min=1e-12)


def _iou_matrix_cuda(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    for b in (boxes1, boxes2):
        if b.dtype != torch.float32:
            raise TypeError(f"iou_matrix takes float32 boxes, got {b.dtype}")
        if b.dim() != 2 or b.shape[1] != 6 or not b.is_contiguous():
            raise ValueError(f"iou_matrix takes contiguous [N, 6] boxes, got {tuple(b.shape)}")
    if boxes1.device != boxes2.device:
        raise ValueError("boxes1 and boxes2 on different devices")
    n, m = boxes1.shape[0], boxes2.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=boxes1.device)
    with torch.cuda.device(boxes1.device):
        err = _kernel()(boxes1.data_ptr(), boxes2.data_ptr(), n, m, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "iou_matrix_launch")
    LAUNCHES["iou_matrix"] += 1
    return out


def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``[N, M]`` float32 of ``boxes1 [N, 6]`` and
    ``boxes2 [M, 6]`` (``(x1, y1, x2, y2, z1, z2)``)."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    if n == 0 or m == 0:
        return torch.zeros((n, m), dtype=torch.float32, device=boxes1.device)
    if boxes1.device.type == "cpu":
        return iou_matrix_plain(boxes1, boxes2)
    if boxes1.device.type == "cuda":
        return _iou_matrix_cuda(boxes1.float().contiguous(), boxes2.float().contiguous())
    raise NotImplementedError(f"iou_matrix has no kernel for {boxes1.device}")
