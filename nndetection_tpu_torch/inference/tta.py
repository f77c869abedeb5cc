"""Test-time augmentation: mirror flips with box-aware inversion (counterpart
of :mod:`nndetection_tpu.inference.tta`).

In 3D the full set is the identity + 7 axis-flip combinations. Flipping axis
``a`` maps a box span ``[lo, hi)`` to ``[S_a - hi, S_a - lo)``.
"""
from __future__ import annotations

from itertools import combinations
from typing import List, Sequence, Tuple

import torch

from nndetection_tpu_torch.utils import trace

_LO_IDX = {0: 0, 1: 1, 2: 4}
_HI_IDX = {0: 2, 1: 3, 2: 5}


def get_tta_flips(dim: int = 3, enabled: bool = True) -> List[Tuple[int, ...]]:
    """All flip-axis combinations, identity first."""
    if not enabled:
        return [()]
    axes = list(range(dim))
    out: List[Tuple[int, ...]] = [()]
    for r in range(1, dim + 1):
        out.extend(tuple(c) for c in combinations(axes, r))
    return out


def flip_image(images: torch.Tensor, flips: Sequence[int], spatial_offset: int = 1) -> torch.Tensor:
    """Flip the spatial axes ``flips`` of ``[..., *spatial, C]`` tensors whose
    spatial axes start at ``spatial_offset``."""
    if not flips:
        return images
    return torch.flip(images, dims=[f + spatial_offset for f in flips])


def invert_seg(seg: torch.Tensor, flips: Sequence[int], spatial_offset: int = 1) -> torch.Tensor:
    """Inverse mirror of segmentation maps (a flip is its own inverse)."""
    return flip_image(seg, flips, spatial_offset)


def invert_boxes(boxes: torch.Tensor, flips: Sequence[int], patch_size: Sequence[int]) -> torch.Tensor:
    """Map boxes ``[..., 2*dim]`` predicted on a flipped tile back to
    unflipped tile coordinates: per flipped axis, swap lo/hi and reflect."""
    if not flips:
        return boxes
    n_cols = boxes.shape[-1]
    perm = list(range(n_cols))
    sign = [1.0] * n_cols
    offset = [0.0] * n_cols
    for a in flips:
        lo, hi = _LO_IDX[a], _HI_IDX[a]
        perm[lo], perm[hi] = hi, lo
        sign[lo] = sign[hi] = -1.0
        offset[lo] = offset[hi] = float(patch_size[a])
    # three copies from pageable memory (the list index among them): on the
    # card the host waits here for the work queued before them
    with trace.span("sync.copy"):
        sign_t = torch.tensor(sign, dtype=boxes.dtype, device=boxes.device)
        offset_t = torch.tensor(offset, dtype=boxes.dtype, device=boxes.device)
        permuted = boxes[..., perm]
    return permuted * sign_t + offset_t
