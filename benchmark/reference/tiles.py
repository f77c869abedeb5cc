"""Sliding-window tiling of a case, NumPy: the case padded symmetrically up
to the patch where it is smaller, then tile origins that cover it with
half-patch overlap, the leftover spread evenly (nnDetection's
``nndet/inference/sliding.py`` as ``nndetection_tpu_torch/data/patching.py``
states it, frozen here)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def pad_to_min_shape(data: np.ndarray, min_shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """``data [C, *spatial]`` padded with zeros up to ``min_shape``; returns it
    and the lower padding of each axis."""
    pads, lower = [(0, 0)], []
    for s, m in zip(data.shape[1:], min_shape):
        total = max(0, m - s)
        pads.append((total // 2, total - total // 2))
        lower.append(total // 2)
    if any(p != (0, 0) for p in pads):
        data = np.pad(data, pads, mode="constant")
    return data, np.asarray(lower, np.int64)


def grid(case_shape: Sequence[int], patch: Sequence[int], overlap: float = 0.5) -> np.ndarray:
    """``[T, dim]`` tile origins, the first axis slowest."""
    per_axis: List[np.ndarray] = []
    for size, p in zip(case_shape, patch):
        p = min(p, size)
        step = max(1, int(round(p * (1.0 - overlap))))
        if size == p:
            starts = np.asarray([0])
        else:
            n = int(np.ceil((size - p) / step)) + 1
            starts = np.unique(np.round(np.linspace(0, size - p, n)).astype(np.int64))
        per_axis.append(starts.astype(np.int64))
    mesh = np.meshgrid(*per_axis, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=1)
