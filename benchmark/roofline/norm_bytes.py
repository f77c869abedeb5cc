"""The bytes the instance norm has to move, frozen from the kernels' design
(``nndetection_tpu_torch/ops/instance_norm.py``): each kernel reads its
inputs once and writes its outputs once, in the map's type.

* #1, the statistics: the depth planes the statistics read (every
  ``stride``-th from ``stride // 2`` where the map has ``2 * stride`` planes
  or more, all otherwise);
* #2, the apply: the map, read and written;
* #3, the gradient sums: the map and its gradient, read;
* #4, the input gradient: the map and its gradient read, the input gradient
  written.

The per-(image, channel) statistics and sums are a few floats a channel
and are left out. ``shape`` is an instance norm's input ``[B, C, D, *rest]``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence


def selected_planes(depth: int, stride: Optional[int]) -> int:
    if not stride or depth < 2 * stride:
        return depth
    return len(range(stride // 2, depth, stride))


def forward_bytes(shape: Sequence[int], stride: Optional[int], elem: int = 2) -> int:
    """#1 and #2 of one forward instance norm."""
    b, c, d = shape[0], shape[1], shape[2]
    rest = math.prod(shape[3:])
    full = b * c * d * rest * elem
    return b * c * selected_planes(d, stride) * rest * elem + 2 * full


def backward_bytes(shape: Sequence[int], elem: int = 2) -> int:
    """#3 and #4 of one backward instance norm."""
    return 5 * math.prod(shape) * elem
