"""Anchor size optimization by black-box search (copy of
:mod:`nndetection_tpu.planning.anchors_opt`).

nnDetection optimizes the per-level anchor sizes with nevergrad's
TwoPointsDE, maximizing the mean best-anchor IoU of the dataset's
zero-centred GT boxes over the pyramid strides. This is a compact
differential evolution in NumPy with the same objective, seeded by
``RandomState(seed)``. All boxes and anchors are zero-centred, so the IoU
is an axis-wise min / max product.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def centered_iou(sizes_a: np.ndarray, sizes_b: np.ndarray) -> np.ndarray:
    """IoU of zero-centered boxes given per-axis sizes ``[N, dim]``/``[M, dim]``
    -> ``[N, M]``."""
    a = sizes_a[:, None, :].astype(np.float64)
    b = sizes_b[None, :, :].astype(np.float64)
    inter = np.prod(np.minimum(a, b), axis=-1)
    union = np.prod(a, axis=-1) + np.prod(b, axis=-1) - inter
    return inter / np.maximum(union, 1e-12)


def anchor_set_from_params(
    params: np.ndarray, strides: Sequence[Sequence[float]]
) -> np.ndarray:
    """Expand ``3*dim`` per-axis sizes (3 per axis, level-0) into the full
    multi-level anchor size set ``[3^dim * L, dim]`` (dim inferred from the
    stride vectors; the reference's 3D-only helper generalized)."""
    dim = len(strides[0])
    groups = [params[3 * a : 3 * (a + 1)] for a in range(dim)]
    base = np.stack(np.meshgrid(*groups, indexing="ij"), -1).reshape(-1, dim)
    out = []
    for st in strides:
        out.append(base * np.asarray(st, dtype=np.float64)[None])
    return np.concatenate(out, axis=0)


def anchor_objective(
    params: np.ndarray,
    gt_sizes: np.ndarray,
    strides: Sequence[Sequence[float]],
) -> float:
    """Mean over GT boxes of max IoU against the full anchor set (negated for
    minimization)."""
    anchors = anchor_set_from_params(np.abs(params), strides)
    iou = centered_iou(gt_sizes, anchors)
    return -float(np.mean(np.max(iou, axis=1)))


def optimize_anchors(
    gt_sizes: np.ndarray,
    strides: Sequence[Sequence[float]],
    budget: int = 5000,
    restarts: int = 3,
    seed: int = 0,
    pop_size: int = 24,
) -> Tuple[np.ndarray, float]:
    """Differential evolution (rand/1/bin) over the 9 anchor parameters.

    Args:
        gt_sizes: per-axis sizes of (filtered) GT boxes ``[N, dim]`` in
            voxels of the highest-resolution decoder level
        strides: relative stride of each decoder level w.r.t. the first

    Returns:
        ``(best_params [3*dim], best_score)`` with score = mean max-IoU.
    """
    dim = len(strides[0])
    if len(gt_sizes) == 0:
        default = np.asarray([8.0, 16.0, 32.0] * dim)
        return default, 0.0
    rng = np.random.RandomState(seed)
    lo = np.maximum(np.percentile(gt_sizes, 1, axis=0).min() * 0.25, 1.0)
    hi = np.percentile(gt_sizes, 99, axis=0).max() * 1.5

    best_params, best_val = None, np.inf
    gens = max(1, budget // (pop_size * max(restarts, 1)))
    for r in range(restarts):
        # init population around size percentiles
        pcts = np.percentile(gt_sizes, [25, 50, 75], axis=0)  # [3, dim]
        center = np.concatenate([pcts[:, a] for a in range(dim)])
        pop = center[None] * rng.uniform(0.5, 1.5, size=(pop_size, 3 * dim))
        pop = np.clip(pop, lo, hi)
        vals = np.array([anchor_objective(p, gt_sizes, strides) for p in pop])
        for _ in range(gens):
            for i in range(pop_size):
                a, b, c = pop[rng.choice(pop_size, 3, replace=False)]
                mutant = np.clip(a + 0.8 * (b - c), lo, hi)
                cross = rng.rand(3 * dim) < 0.9
                trial = np.where(cross, mutant, pop[i])
                v = anchor_objective(trial, gt_sizes, strides)
                if v < vals[i]:
                    pop[i], vals[i] = trial, v
        i = int(np.argmin(vals))
        if vals[i] < best_val:
            best_val, best_params = vals[i], pop[i].copy()
    return np.abs(best_params), -best_val


def filter_boxes_by_volume(
    box_sizes: np.ndarray, lower_pct: float = 0.5, upper_pct: float = 99.5
) -> np.ndarray:
    """Drop extreme-volume outliers before anchor optimization
    (``base.py:424-445``)."""
    if len(box_sizes) == 0:
        return box_sizes
    vols = np.prod(box_sizes.astype(np.float64), axis=1)
    lo, hi = np.percentile(vols, [lower_pct, upper_pct])
    keep = (vols >= lo) & (vols <= hi)
    return box_sizes[keep]
