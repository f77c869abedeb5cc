"""Detection and segmentation heads (counterpart of
:mod:`nndetection_tpu.models.heads`), 2D and 3D.

Classifier and regressor towers are shared across pyramid levels. Outputs are
flattened position-major with the per-location anchors (then classes)
innermost, as the JAX package reshapes its channel-last maps: a
``[N, A*K, *spatial]`` map is moved to channel-last before
``reshape(N, -1, K)``, matching the anchor grid of
:mod:`nndetection_tpu_torch.core.boxes.anchors`.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from nndetection_tpu_torch.models.conv import Conv, ConvNormAct
from nndetection_tpu_torch.parallel.spatial import gather_spatial, get_spatial_axis


def _flatten(y: torch.Tensor, k: int) -> torch.Tensor:
    """``[N, A*k, *spatial]`` -> ``[N, prod(spatial)*A, k]``, position-major.
    Under spatial partitioning the ranks' flattened blocks are all-gathered:
    the anchor order is z-major and the volume is sharded along z, so each
    rank's block is a contiguous slice of the global order."""
    flat = y.movedim(1, -1).reshape(y.shape[0], -1, k)
    group = get_spatial_axis()
    return flat if group is None else gather_spatial(flat, group, spatial_axis=1)


class ConvTower(nn.Module):
    """in-conv + ``num_convs`` internal conv-groupnorm-relu layers
    (``conv{i}``)."""

    def __init__(self, in_channels: int, internal_channels: int, num_convs: int = 1,
                 norm_channels_per_group: int = 16, dim: int = 3):
        super().__init__()
        self.depth = 1 + num_convs
        for i in range(self.depth):
            self.add_module(f"conv{i}", ConvNormAct(
                in_channels if i == 0 else internal_channels, internal_channels, 3,
                norm="group", norm_channels_per_group=norm_channels_per_group, dim=dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x)
        return x


class Classifier(nn.Module):
    """Logits ``[N, A_total, num_classes]`` over all levels; the out conv's
    bias starts at the prior probability."""

    def __init__(self, in_channels: int, num_classes: int, anchors_per_pos: int,
                 internal_channels: int = 128, num_convs: int = 1,
                 prior_prob: Optional[float] = 0.01, dim: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.tower = ConvTower(in_channels, internal_channels, num_convs, dim=dim)
        bias = 0.0 if prior_prob is None else -math.log((1 - prior_prob) / prior_prob)
        self.out = Conv(internal_channels, anchors_per_pos * num_classes, 3,
                        init="normal_0.01", bias_value=bias, dim=dim)

    def forward(self, fmaps: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(
            [_flatten(self.out(self.tower(fm)), self.num_classes) for fm in fmaps], dim=1)


class Regressor(nn.Module):
    """Deltas ``[N, A_total, 2*dim]`` over all levels, each level scaled by
    its learnable ``scales[level]``."""

    def __init__(self, in_channels: int, anchors_per_pos: int, num_levels: int,
                 internal_channels: int = 128, num_convs: int = 1,
                 learn_scale: bool = True, dim: int = 3):
        super().__init__()
        self.n_coords = 2 * dim
        self.tower = ConvTower(in_channels, internal_channels, num_convs, dim=dim)
        self.out = Conv(internal_channels, anchors_per_pos * self.n_coords, 3,
                        init="normal_0.01", dim=dim)
        self.scales = nn.Parameter(torch.ones(num_levels)) if learn_scale else None

    def forward(self, fmaps: List[torch.Tensor]) -> torch.Tensor:
        deltas = []
        for level, fm in enumerate(fmaps):
            y = self.out(self.tower(fm))
            if self.scales is not None:
                y = y * self.scales[level].to(y.dtype)
            deltas.append(_flatten(y, self.n_coords))
        return torch.cat(deltas, dim=1)


class Segmenter(nn.Module):
    """1x1 conv on the highest-resolution decoder map: channel-last logits
    ``[N, *spatial, seg_classes + 1]`` (background first)."""

    def __init__(self, in_channels: int, seg_classes: int = 1, dim: int = 3):
        super().__init__()
        self.out = Conv(in_channels, seg_classes + 1, 1, init="lecun_normal", dim=dim)

    def forward(self, fmaps: List[torch.Tensor]) -> torch.Tensor:
        return self.out(fmaps[0]).movedim(1, -1)


class DeepSupervisionSegmenter(nn.Module):
    """1x1 convs ``out_P{level}`` on the decoder maps of the first
    ``min(num_levels, len(in_channels))`` levels: one channel-last logits
    map per supervised level, the highest resolution first. The loss max-pools
    the target to each level's size
    (:func:`nndetection_tpu_torch.losses.deep_supervision_seg_loss`)."""

    def __init__(self, in_channels: Sequence[int], seg_classes: int = 1, num_levels: int = 3,
                 dim: int = 3):
        super().__init__()
        self.num_levels = min(num_levels, len(in_channels))
        for level in range(self.num_levels):
            self.add_module(f"out_P{level}", Conv(
                in_channels[level], seg_classes + 1, 1, init="lecun_normal", dim=dim))

    def forward(self, fmaps: List[torch.Tensor]) -> List[torch.Tensor]:
        return [getattr(self, f"out_P{level}")(fmaps[level]).movedim(1, -1)
                for level in range(self.num_levels)]
