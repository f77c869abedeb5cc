"""The cluster loop of weighted box clustering: the counterpart of the
``lax.while_loop`` of ``nndetection_tpu/core/boxes/wbc.py::wbc``.

:func:`wbc_cluster` launches the CUDA kernel of ``csrc/wbc_cluster.cu`` (one
block per class) for CUDA tensors and runs :func:`wbc_cluster_plain` for CPU
tensors. Both take the boxes and compute the IoUs they need themselves, and
cluster each class on its own; the output of class ``c`` is row ``c`` of
``[C, N]`` arrays, clusters in the order they formed, padded with zeros and
``valid = False``. Both take 3D boxes; :func:`wbc_cluster` lifts 2D boxes to
unit depth in front of them (:func:`nndetection_tpu_torch.ops.lift_2d`) and
slices the lifted z off the cluster boxes: the IoUs are the 2D ones, and the
x and y sums do not see z.

The kernel sorts each class's boxes once, walks them in that order to find
the seeds (the greedy NMS keep set) and each box's cluster, and sums each
cluster's members in increasing index, one float32 add at a time; the plain
version sums in that order too, so the two agree bit for bit.
:func:`plan_wbc` sizes the kernel's scratch: in shared memory, or for large
N in a global workspace.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from nndetection_tpu_torch.ops import LAUNCHES, _build, lift_2d
from nndetection_tpu_torch.ops.iou_matrix import iou_matrix_plain

# dynamic shared memory one block may opt into on the H100 (227 KB)
SMEM_MAX = 232_448

_launch_fn = None


@dataclass(frozen=True)
class WbcPlan:
    """How the kernel runs over ``n`` boxes: the ``n_pad`` keys (a power of
    two) its sorts run over, the dynamic shared memory in bytes, and
    ``ws_words``, the 8-byte words of global workspace per class that hold
    the scratch (0: it sits in shared memory)."""

    n: int
    n_pad: int
    smem_bytes: int
    ws_words: int


@functools.lru_cache(maxsize=None)
def plan_wbc(n: int, smem_bytes: int = SMEM_MAX) -> WbcPlan:
    """The kernel's launch for ``n`` boxes on a card whose blocks may take
    ``smem_bytes`` of shared memory. The sorts run over ``n`` padded to a
    power of two, at least the 64 keys a warp sorts in registers (``kSeg``
    of ``csrc/box_geometry.cuh``). The scratch, 8 B per padded key and
    ``kBoxBytes`` per box (``csrc/wbc_cluster.cu``), sits in shared memory
    behind the kernel's header (``kHeaderWords``) where it fits, else in a
    global workspace of ``ws_words`` per class, an even number so that each
    class's slice stays 16-byte aligned."""
    if n < 1 or n > 1 << 30:
        raise ValueError(f"wbc_cluster plan needs 1 <= n <= 2**30, got {n}")
    geo = _build.constants("wbc_cluster.cu")
    n_pad = max(geo["kSeg"], 1 << (n - 1).bit_length())
    header = 4 * geo["kHeaderWords"]
    scratch = 8 * n_pad + geo["kBoxBytes"] * n
    if header + scratch <= smem_bytes:
        return WbcPlan(n, n_pad, header + scratch, 0)
    return WbcPlan(n, n_pad, header, 2 * -(-scratch // 16))


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load().wbc_cluster_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # boxes, scores, weights
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # n_exp, labels, valid
            ctypes.c_int, ctypes.c_int, ctypes.c_int,           # n, n_pad, classes
            ctypes.c_float, ctypes.c_float, ctypes.c_float,     # iou, score thr, missing w
            ctypes.c_void_p, ctypes.c_longlong,                 # workspace, its words per class
            ctypes.c_int,                                       # smem bytes
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out boxes, scores, valid
            ctypes.c_void_p, ctypes.c_int,                      # stream, device
        ]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def wbc_cluster_plain(
    boxes, scores, weights, n_exp, labels, valid, num_classes,
    iou_thresh, score_thresh, missing_weight=1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: a Python loop over the clusters
    of each class, float32, each seed's IoU row from :func:`iou_matrix_plain`
    (the kernel's arithmetic), each cluster's members summed in increasing
    index, one add at a time. Arguments and outputs as :func:`wbc_cluster`."""
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
            iou = iou_matrix_plain(boxes[seed:seed + 1], boxes)[0]
            cluster = remaining & (iou > iou_thr)
            remaining = remaining & ~cluster
            remaining[seed] = False  # also when outside its own cluster
            members = torch.nonzero(cluster).flatten()  # increasing index
            msw = iou[members] * weights[members]
            ms = msw * scores[members]
            terms = torch.stack([torch.ones_like(ms), n_exp[members], msw, ms]
                                + [boxes[members, d] * ms for d in range(6)], dim=1)
            sums = torch.zeros(10, **f32)
            for term in terms:
                sums = sums + term
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


def _wbc_cluster_cuda(boxes, scores, weights, n_exp, labels, valid, num_classes,
                      iou_thresh, score_thresh, missing_weight):
    n = scores.shape[0]
    dev = scores.device
    for name, t, dtype, shape in (
            ("boxes", boxes, torch.float32, (n, 6)), ("scores", scores, torch.float32, (n,)),
            ("weights", weights, torch.float32, (n,)), ("n_exp", n_exp, torch.float32, (n,)),
            ("labels", labels, torch.int32, (n,)), ("valid", valid, torch.bool, (n,))):
        # one test per tensor on the common path: the call's host time counts
        if (t.dtype == dtype and t.shape == shape and t.is_contiguous()
                and t.get_device() == dev.index):
            continue
        if t.dtype != dtype:
            raise TypeError(f"wbc_cluster {name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"wbc_cluster {name} on {t.device}, scores on {dev}")
        raise ValueError(f"wbc_cluster {name} must be contiguous {shape}, got {tuple(t.shape)}")
    plan = plan_wbc(n)
    out_boxes = torch.empty((num_classes, n, 6), dtype=torch.float32, device=dev)
    out_scores = torch.empty((num_classes, n), dtype=torch.float32, device=dev)
    out_valid = torch.empty((num_classes, n), dtype=torch.bool, device=dev)
    # large N only: the scratch in global memory, one slice per class
    ws = (torch.empty((num_classes, plan.ws_words), dtype=torch.int64, device=dev)
          if plan.ws_words else None)
    err = _kernel()(
        boxes.data_ptr(), scores.data_ptr(), weights.data_ptr(), n_exp.data_ptr(),
        labels.data_ptr(), valid.data_ptr(), n, plan.n_pad, num_classes,
        float(iou_thresh), float(score_thresh), float(missing_weight),
        ws.data_ptr() if ws is not None else None, plan.ws_words, plan.smem_bytes,
        out_boxes.data_ptr(), out_scores.data_ptr(), out_valid.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index), dev.index,
    )
    _build.check(err, "wbc_cluster_launch")
    LAUNCHES["wbc_cluster"] += 1
    return out_boxes, out_scores, out_valid


def wbc_cluster(
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
        boxes: ``[N, 6]`` float32, or ``[N, 4]`` (2D)
        scores, weights, n_exp: ``[N]`` float32 (weights already multiplied
            by the box volume where the caller wants ``use_area``)
        labels: ``[N]`` int32; class ``c`` clusters the boxes of label ``c``
        valid: ``[N]`` bool
        num_classes: classes ``0 .. C-1``

    Returns ``(boxes [C, N, 6 or 4], scores [C, N], valid [C, N] bool)``.
    """
    n_coords = boxes.shape[-1]
    args = (lift_2d(boxes), scores, weights, n_exp, labels, valid, num_classes, iou_thresh,
            score_thresh, missing_weight)
    # nothing to cluster needs no launch
    if scores.shape[0] == 0 or num_classes == 0 or scores.device.type == "cpu":
        out_boxes, out_scores, out_valid = wbc_cluster_plain(*args)
    elif scores.device.type == "cuda":
        out_boxes, out_scores, out_valid = _wbc_cluster_cuda(*args)
    else:
        raise NotImplementedError(f"wbc_cluster has no kernel for {scores.device}")
    return out_boxes[..., :n_coords], out_scores, out_valid
