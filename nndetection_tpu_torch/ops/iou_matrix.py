"""Pairwise 3D IoU matrix: the counterpart of
``nndetection_tpu/ops/pallas_ops.py::iou_matrix_pallas``.

:func:`iou_matrix` launches the CUDA kernel of ``csrc/iou_matrix.cu`` for
CUDA tensors, on the grid :func:`plan_iou` picks, and runs
:func:`iou_matrix_plain` for CPU tensors. Both compute
``inter / max(union, 1e-12)`` in float32 in the Pallas kernel's order, every
max and min carrying NaN, so a pair of zero-volume boxes has IoU 0
(``core/boxes/ops.py::box_iou`` of the JAX package gives NaN there) and a
box with a NaN coordinate has IoU NaN with every box.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from nndetection_tpu_torch.ops import LAUNCHES, _build

# blocks per SM the plan aims at: two waves of the four 256-thread blocks an
# SM holds at once
BLOCKS_PER_SM = 8
# rows a warp walks at least: with one, a block stages 136 boxes for 1024
# pairs, and 1000 x 1000 took 0.0082 ms against 0.0075 with two (NVIDIA H100
# 80GB HBM3, 700 W; chip_smoke.py's kernels phase)
MIN_ROWS_PER_WARP = 2

_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load().iou_matrix_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # boxes1, boxes2
            ctypes.c_int, ctypes.c_int,        # n, m
            ctypes.c_int, ctypes.c_int,        # rows per warp, vector
            ctypes.c_void_p, ctypes.c_void_p,  # out, stream
        ]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


@dataclass(frozen=True)
class IouPlan:
    """The kernel's grid for an ``n x m`` matrix: each block covers 128
    columns and ``8 * rows_per_warp`` rows; ``vector``: 16-byte stores (``m
    % 4 == 0``), else one float at a time."""
    rows_per_warp: int
    vector: bool
    blocks: int


def plan_iou(n: int, m: int, n_sms: int, rows_per_warp: Optional[int] = None) -> IouPlan:
    """The largest ``rows_per_warp`` (a power of two up to the kernel's
    ``kMaxRowsPerWarp``) whose grid still has ``BLOCKS_PER_SM`` blocks per SM
    of a card with ``n_sms`` SMs, and at least ``MIN_ROWS_PER_WARP``, unless
    forced."""
    geo = _build.constants("iou_matrix.cu")
    warps, cols = geo["kThreads"] // 32, 32 * geo["kColsPerLane"]
    col_tiles = -(-m // cols)

    def blocks(r):
        return col_tiles * -(-n // (warps * r))

    if rows_per_warp is None:
        rows_per_warp = MIN_ROWS_PER_WARP
        while (2 * rows_per_warp <= geo["kMaxRowsPerWarp"]
               and blocks(2 * rows_per_warp) >= BLOCKS_PER_SM * n_sms):
            rows_per_warp *= 2
    if not 1 <= rows_per_warp <= geo["kMaxRowsPerWarp"]:
        raise ValueError(f"rows_per_warp {rows_per_warp} outside 1..{geo['kMaxRowsPerWarp']}")
    return IouPlan(rows_per_warp, m % geo["kColsPerLane"] == 0, blocks(rows_per_warp))


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


def _iou_matrix_cuda(boxes1: torch.Tensor, boxes2: torch.Tensor,
                     plan: Optional[IouPlan] = None) -> torch.Tensor:
    for b in (boxes1, boxes2):
        if b.dtype != torch.float32:
            raise TypeError(f"iou_matrix takes float32 boxes, got {b.dtype}")
        if b.dim() != 2 or b.shape[1] != 6 or not b.is_contiguous():
            raise ValueError(f"iou_matrix takes contiguous [N, 6] boxes, got {tuple(b.shape)}")
    if boxes1.device != boxes2.device:
        raise ValueError("boxes1 and boxes2 on different devices")
    n, m = boxes1.shape[0], boxes2.shape[0]
    if plan is None:
        from nndetection_tpu_torch.ops.conv_in_stats import sm_count

        plan = plan_iou(n, m, sm_count(boxes1.device))
    out = torch.empty((n, m), dtype=torch.float32, device=boxes1.device)
    with torch.cuda.device(boxes1.device):
        err = _kernel()(boxes1.data_ptr(), boxes2.data_ptr(), n, m, plan.rows_per_warp,
                        int(plan.vector), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "iou_matrix_launch")
    LAUNCHES["iou_matrix"] += 1
    return out


def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor,
               plan: Optional[IouPlan] = None) -> torch.Tensor:
    """Pairwise IoU ``[N, M]`` float32 of ``boxes1 [N, 6]`` and
    ``boxes2 [M, 6]`` (``(x1, y1, x2, y2, z1, z2)``); ``plan`` forces the
    kernel's grid (default: :func:`plan_iou`'s)."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    if n == 0 or m == 0:
        return torch.zeros((n, m), dtype=torch.float32, device=boxes1.device)
    if boxes1.device.type == "cpu":
        return iou_matrix_plain(boxes1, boxes2)
    if boxes1.device.type == "cuda":
        return _iou_matrix_cuda(boxes1.float().contiguous(), boxes2.float().contiguous(), plan)
    raise NotImplementedError(f"iou_matrix has no kernel for {boxes1.device}")
