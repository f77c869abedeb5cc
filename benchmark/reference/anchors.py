"""Frozen copy, for the benchmark's reference, of the plain PyTorch code in
``nndetection_tpu_torch/core/boxes/anchors.py``; it imports nothing of the program.

Anchor grid generation (NumPy copy of
:mod:`nndetection_tpu.core.boxes.anchors`).

Anchor grids depend only on the feature-map shapes, the strides and the
planned per-level anchor sizes, so they are computed once in NumPy. Grid
anchor ordering is row-major over spatial positions with the per-location
anchors innermost: exactly the layout the detection heads emit after
flattening ``(s0, s1, s2, A, C)``.
"""
from __future__ import annotations

from itertools import product
from typing import List, Sequence, Tuple, Union

import numpy as np

SizeSpec = Union[int, float, Sequence[Union[int, float]]]


def _as_tuples(spec: Sequence[SizeSpec]) -> List[Tuple[float, ...]]:
    out = []
    for s in spec:
        if isinstance(s, (int, float)):
            out.append((float(s),))
        else:
            out.append(tuple(float(v) for v in s))
    return out


class AnchorGenerator:
    def __init__(
        self,
        width: Sequence[SizeSpec],
        height: Sequence[SizeSpec],
        depth: Sequence[SizeSpec] = None,
        **unused,
    ):
        """
        Args:
            width/height/depth: anchor extents along spatial axes 0/1/2, one
                entry (scalar or tuple) per pyramid level. ``depth=None``
                selects 2D anchors.
        """
        self.width = _as_tuples(width)
        self.height = _as_tuples(height)
        self.depth = _as_tuples(depth) if depth is not None else None
        self.dim = 3 if depth is not None else 2
        if self.depth is not None:
            assert len(self.width) == len(self.height) == len(self.depth)
        else:
            assert len(self.width) == len(self.height)

    @property
    def num_levels(self) -> int:
        return len(self.width)

    def num_anchors_per_location(self) -> List[int]:
        """Anchors per grid position for each level."""
        if self.dim == 2:
            return [len(w) * len(h) for w, h in zip(self.width, self.height)]
        return [
            len(w) * len(h) * len(d)
            for w, h, d in zip(self.width, self.height, self.depth)
        ]

    def cell_anchors(self, level: int) -> np.ndarray:
        """Zero-centered anchors ``[A, 2*dim]`` for one level."""
        if self.dim == 2:
            sizes = np.array(
                list(product(self.width[level], self.height[level])), dtype=np.float32
            )
            half = sizes / 2.0
            return np.stack(
                [-half[:, 0], -half[:, 1], half[:, 0], half[:, 1]], axis=1
            )
        sizes = np.array(
            list(product(self.width[level], self.height[level], self.depth[level])),
            dtype=np.float32,
        )
        half = sizes / 2.0
        return np.stack(
            [
                -half[:, 0],
                -half[:, 1],
                half[:, 0],
                half[:, 1],
                -half[:, 2],
                half[:, 2],
            ],
            axis=1,
        )

    def grid_anchors(
        self,
        feature_shapes: Sequence[Sequence[int]],
        strides: Sequence[Sequence[int]],
    ) -> Tuple[np.ndarray, List[int]]:
        """Generate anchors for all levels.

        Args:
            feature_shapes: spatial shape of each pyramid level.
            strides: cumulative stride of each level w.r.t. the input.

        Returns:
            ``(anchors [sum_l prod(shape_l)*A_l, 2*dim], anchors_per_level)``
        """
        assert len(feature_shapes) == len(strides) == self.num_levels
        all_anchors = []
        per_level = []
        for level, (shape, stride) in enumerate(zip(feature_shapes, strides)):
            cell = self.cell_anchors(level)  # [A, 2*dim]
            axes = [
                np.arange(s, dtype=np.float32) * float(st)
                for s, st in zip(shape, stride)
            ]
            grids = np.meshgrid(*axes, indexing="ij")
            ctr = np.stack([g.reshape(-1) for g in grids], axis=1)  # [P, dim]
            if self.dim == 2:
                shifts = ctr[:, [0, 1, 0, 1]]
            else:
                shifts = ctr[:, [0, 1, 0, 1, 2, 2]]
            anchors = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 2 * self.dim)
            all_anchors.append(anchors)
            per_level.append(anchors.shape[0])
        return np.concatenate(all_anchors, axis=0).astype(np.float32), per_level
