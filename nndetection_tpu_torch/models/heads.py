"""Detection and segmentation heads (counterpart of
:mod:`nndetection_tpu.models.heads`; ``DeepSupervisionSegmenter`` comes
later).

Classifier and regressor towers are shared across pyramid levels. Outputs are
flattened position-major with the per-location anchors (then classes)
innermost, as the JAX package reshapes its NDHWC maps: a ``[N, A*K, D, H, W]``
map is moved to channel-last before ``reshape(N, -1, K)``, matching the anchor
grid of :mod:`nndetection_tpu_torch.core.boxes.anchors`.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from nndetection_tpu_torch.models.conv import Conv, ConvNormAct


def _flatten(y: torch.Tensor, k: int) -> torch.Tensor:
    """``[N, A*k, *spatial]`` -> ``[N, prod(spatial)*A, k]``, position-major."""
    return y.permute(0, 2, 3, 4, 1).reshape(y.shape[0], -1, k)


class ConvTower(nn.Module):
    """in-conv + ``num_convs`` internal conv-groupnorm-relu layers
    (``conv{i}``)."""

    def __init__(self, in_channels: int, internal_channels: int, num_convs: int = 1,
                 norm_channels_per_group: int = 16):
        super().__init__()
        self.depth = 1 + num_convs
        for i in range(self.depth):
            self.add_module(f"conv{i}", ConvNormAct(
                in_channels if i == 0 else internal_channels, internal_channels, 3,
                norm="group", norm_channels_per_group=norm_channels_per_group))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x)
        return x


class Classifier(nn.Module):
    """Logits ``[N, A_total, num_classes]`` over all levels; the out conv's
    bias starts at the prior probability."""

    def __init__(self, in_channels: int, num_classes: int, anchors_per_pos: int,
                 internal_channels: int = 128, num_convs: int = 1,
                 prior_prob: Optional[float] = 0.01):
        super().__init__()
        self.num_classes = num_classes
        self.tower = ConvTower(in_channels, internal_channels, num_convs)
        bias = 0.0 if prior_prob is None else -math.log((1 - prior_prob) / prior_prob)
        self.out = Conv(internal_channels, anchors_per_pos * num_classes, 3,
                        init="normal_0.01", bias_value=bias)

    def forward(self, fmaps: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(
            [_flatten(self.out(self.tower(fm)), self.num_classes) for fm in fmaps], dim=1)


class Regressor(nn.Module):
    """Deltas ``[N, A_total, 6]`` over all levels, each level scaled by its
    learnable ``scales[level]``."""

    def __init__(self, in_channels: int, anchors_per_pos: int, num_levels: int,
                 internal_channels: int = 128, num_convs: int = 1,
                 learn_scale: bool = True):
        super().__init__()
        self.tower = ConvTower(in_channels, internal_channels, num_convs)
        self.out = Conv(internal_channels, anchors_per_pos * 6, 3, init="normal_0.01")
        self.scales = nn.Parameter(torch.ones(num_levels)) if learn_scale else None

    def forward(self, fmaps: List[torch.Tensor]) -> torch.Tensor:
        deltas = []
        for level, fm in enumerate(fmaps):
            y = self.out(self.tower(fm))
            if self.scales is not None:
                y = y * self.scales[level].to(y.dtype)
            deltas.append(_flatten(y, 6))
        return torch.cat(deltas, dim=1)


class Segmenter(nn.Module):
    """1x1 conv on the highest-resolution decoder map: channel-last logits
    ``[N, D, H, W, seg_classes + 1]`` (background first)."""

    def __init__(self, in_channels: int, seg_classes: int = 1):
        super().__init__()
        self.out = Conv(in_channels, seg_classes + 1, 1, init="lecun_normal")

    def forward(self, fmaps: List[torch.Tensor]) -> torch.Tensor:
        return self.out(fmaps[0]).permute(0, 2, 3, 4, 1)
