"""Untruncated greedy NMS over score-sorted boxes in two steps, the
suppression relation and the keep-scan over it: the counterparts of
``nndetection_tpu/ops/pallas_ops.py::suppression_matrix_pallas`` and of the
``lax.fori_loop`` of ``nndetection_tpu/core/boxes/nms.py::nms_mask``.

The relation is a bitmask: row ``i`` is ``ceil(N/64)`` 64-bit words (int64
tensors), bit ``b`` of word ``w`` set iff box ``j = 64*w + b`` comes after box
``i`` (``j > i``) and ``IoU(i, j) > thr`` in float32. :func:`unpack_words`
turns it into the Pallas kernel's ``[N, N]`` matrix.

:func:`suppression_matrix` and :func:`nms_keep_scan` launch the kernels of
``csrc/suppression_matrix.cu`` for CUDA tensors and run the plain versions
for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from nndetection_tpu_torch.ops import LAUNCHES, _build, lift_2d
from nndetection_tpu_torch.ops.iou_matrix import iou_matrix_plain

BITS = 64
# the keep-scan's removed vector in one block's shared memory: 227 KB / 8 B
# per word, 64 boxes per word
MAX_BOXES_SCAN_CUDA = (232448 // 8) * BITS

_launch_fns = {}


def _kernel(name: str, argtypes):
    fn = _launch_fns.get(name)
    if fn is None:
        fn = getattr(_build.load(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _launch_fns[name] = fn
    return fn


def num_words(n: int) -> int:
    return (n + BITS - 1) // BITS


def _bit_values(device) -> torch.Tensor:
    """``1 << b`` for b in 0..63 as int64 (bit 63 is the sign bit)."""
    return torch.bitwise_left_shift(torch.ones(BITS, dtype=torch.int64, device=device),
                                    torch.arange(BITS, device=device))


def pack_words(rel: torch.Tensor) -> torch.Tensor:
    """``[N, M]`` bool -> ``[N, ceil(M/64)]`` int64 words."""
    n, m = rel.shape
    w = num_words(m)
    padded = torch.zeros((n, w * BITS), dtype=torch.int64, device=rel.device)
    padded[:, :m] = rel.long()
    # distinct powers of two: the sum has no carries, so it is the OR
    return (padded.view(n, w, BITS) * _bit_values(rel.device)).sum(-1)


def unpack_words(words: torch.Tensor, m: int) -> torch.Tensor:
    """``[N, W]`` int64 words -> ``[N, m]`` bool."""
    n, w = words.shape
    bits = torch.bitwise_and(words[:, :, None], _bit_values(words.device)) != 0
    return bits.view(n, w * BITS)[:, :m]


def suppression_matrix_plain(boxes_sorted: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version: the IoU matrix in the kernel's order, compared
    with the float32 threshold above the diagonal, packed into words."""
    n = boxes_sorted.shape[0]
    iou = iou_matrix_plain(boxes_sorted, boxes_sorted)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=iou.device)
    upper = torch.ones((n, n), dtype=torch.bool, device=iou.device).triu(1)
    return pack_words((iou > thr) & upper)


def nms_keep_scan_plain(sup: torch.Tensor, valid_sorted: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the keep-scan: row ``i`` is kept iff it is
    valid and no kept row before it suppresses it."""
    n = valid_sorted.shape[0]
    rel = unpack_words(sup, n)
    keep = valid_sorted.clone()
    for i in range(n):
        if keep[i]:
            keep &= ~rel[i]
    return keep


def _check_cuda(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what} takes a contiguous {tuple(shape)} tensor, got {tuple(t.shape)}")


def _suppression_matrix_cuda(boxes_sorted: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    n = boxes_sorted.shape[0]
    _check_cuda(boxes_sorted, torch.float32, (n, 6), "suppression_matrix")
    out = torch.empty((n, num_words(n)), dtype=torch.int64, device=boxes_sorted.device)
    fn = _kernel("suppression_matrix_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float,  # boxes, n, threshold
        ctypes.c_void_p, ctypes.c_void_p,               # out words, stream
    ])
    with torch.cuda.device(boxes_sorted.device):
        err = fn(boxes_sorted.data_ptr(), n, float(iou_threshold), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "suppression_matrix_launch")
    LAUNCHES["suppression_matrix"] += 1
    return out


def _nms_keep_scan_cuda(sup: torch.Tensor, valid_sorted: torch.Tensor) -> torch.Tensor:
    n = valid_sorted.shape[0]
    if n > MAX_BOXES_SCAN_CUDA:
        raise ValueError(f"nms_keep_scan holds at most {MAX_BOXES_SCAN_CUDA} boxes, got {n}")
    _check_cuda(sup, torch.int64, (n, num_words(n)), "nms_keep_scan words")
    _check_cuda(valid_sorted, torch.bool, (n,), "nms_keep_scan valid")
    if sup.device != valid_sorted.device:
        raise ValueError("words and valid flags on different devices")
    keep = torch.empty((n,), dtype=torch.bool, device=sup.device)
    fn = _kernel("nms_keep_scan_launch", [
        ctypes.c_void_p, ctypes.c_void_p,  # words, valid
        ctypes.c_int, ctypes.c_int,        # n, words per row
        ctypes.c_void_p, ctypes.c_void_p,  # keep, stream
    ])
    with torch.cuda.device(sup.device):
        err = fn(sup.data_ptr(), valid_sorted.data_ptr(), n, num_words(n), keep.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "nms_keep_scan_launch")
    LAUNCHES["nms_keep_scan"] += 1
    return keep


def suppression_matrix(boxes_sorted: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Suppression words ``[N, ceil(N/64)]`` int64 of score-sorted boxes
    ``[N, 6]`` (or ``[N, 4]``, lifted to unit depth by
    :func:`nndetection_tpu_torch.ops.lift_2d`): bit ``j`` of row ``i`` iff
    ``j > i`` and ``IoU(i, j) > iou_threshold``."""
    boxes_sorted = lift_2d(boxes_sorted)
    n = boxes_sorted.shape[0]
    if n == 0:
        return torch.zeros((0, 0), dtype=torch.int64, device=boxes_sorted.device)
    if boxes_sorted.device.type == "cpu":
        return suppression_matrix_plain(boxes_sorted, iou_threshold)
    if boxes_sorted.device.type == "cuda":
        return _suppression_matrix_cuda(boxes_sorted.float().contiguous(), iou_threshold)
    raise NotImplementedError(f"suppression_matrix has no kernel for {boxes_sorted.device}")


def nms_keep_scan(sup: torch.Tensor, valid_sorted: torch.Tensor) -> torch.Tensor:
    """Greedy keep-scan over :func:`suppression_matrix`'s words: ``[N]``
    bool, on the device of its inputs (no host synchronisation)."""
    n = valid_sorted.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=valid_sorted.device)
    if valid_sorted.device.type == "cpu":
        return nms_keep_scan_plain(sup, valid_sorted)
    if valid_sorted.device.type == "cuda":
        return _nms_keep_scan_cuda(sup.contiguous(), valid_sorted.bool().contiguous())
    raise NotImplementedError(f"nms_keep_scan has no kernel for {valid_sorted.device}")
