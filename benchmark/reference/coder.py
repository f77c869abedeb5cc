"""Frozen copy, for the benchmark's reference, of the plain PyTorch code in
``nndetection_tpu_torch/core/boxes/coder.py``; it imports nothing of the program.

Box encoding and decoding against anchors (counterpart of
:mod:`nndetection_tpu.core.boxes.coder`).

Targets are ``(dx, dy, dw, dh, (dz, dd))``: normalized center offsets and log
size ratios, with a clip on the log-size terms before ``exp``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .boxes import box_corners, boxes_from_corners, columns


class BoxCoder:
    def __init__(
        self,
        weights: Optional[Sequence[float]] = None,
        bbox_xform_clip: float = math.log(1000.0 / 16),
        dim: int = 3,
    ):
        """
        Args:
            weights: per-target weights ``(wx, wy, ww, wh, (wz, wd))``;
                defaults to all ones.
            bbox_xform_clip: max value for log-size targets before exp.
            dim: number of spatial dims (2 or 3).
        """
        self.dim = dim
        if weights is None:
            weights = (1.0,) * (2 * dim)
        assert len(weights) == 2 * dim
        self.weights = tuple(float(w) for w in weights)
        self.bbox_xform_clip = float(bbox_xform_clip)

    def _columns(self):
        # (center columns, size columns) of the (dx, dy, dw, dh, (dz, dd)) layout
        return ([0, 1], [2, 3]) if self.dim == 2 else ([0, 1, 4], [2, 3, 5])

    def encode(self, reference_boxes: torch.Tensor, proposals: torch.Tensor) -> torch.Tensor:
        """Encode ``reference_boxes`` (e.g. matched GT) relative to
        ``proposals`` (anchors): ``[..., N, 2*dim] -> [..., N, 2*dim]``,
        float32."""
        pmin, pmax = box_corners(proposals.float())
        rmin, rmax = box_corners(reference_boxes.float())
        ex_size = pmax - pmin
        ex_ctr = pmin + 0.5 * ex_size
        gt_size = rmax - rmin
        gt_ctr = rmin + 0.5 * gt_size
        w = torch.tensor(self.weights, dtype=torch.float32, device=pmin.device)
        d_ctr = w[: self.dim] * (gt_ctr - ex_ctr) / ex_size
        d_size = w[self.dim :] * torch.log(gt_size / ex_size)
        ctr_cols, size_cols = self._columns()
        parts = {c: d_ctr[..., i] for i, c in enumerate(ctr_cols)}
        parts.update({c: d_size[..., i] for i, c in enumerate(size_cols)})
        return torch.stack([parts[c] for c in range(2 * self.dim)], dim=-1)

    def decode(self, rel_codes: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Decode deltas relative to ``boxes`` (anchors) into corner boxes.

        Shapes ``[..., N, 2*dim] -> [..., N, 2*dim]``, float32.
        """
        codes = rel_codes.float()
        bmin, bmax = box_corners(boxes.float())
        sizes = bmax - bmin
        ctrs = bmin + 0.5 * sizes
        ctr_cols, size_cols = self._columns()
        w = torch.tensor(self.weights, dtype=torch.float32, device=codes.device)
        d_ctr = columns(codes, ctr_cols) / w[: self.dim]
        d_size = (columns(codes, size_cols) / w[self.dim :]).clamp(max=self.bbox_xform_clip)
        pred_ctr = d_ctr * sizes + ctrs
        pred_size = torch.exp(d_size) * sizes
        return boxes_from_corners(pred_ctr - 0.5 * pred_size, pred_ctr + 0.5 * pred_size)
