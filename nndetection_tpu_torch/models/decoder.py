"""U-FPN decoders (counterpart of :mod:`nndetection_tpu.models.decoder`
with its defaults: one 1x1 lateral conv per level, transposed-conv
up-sampling, no fusion or out convs). :class:`PAUFPN`, which no plan builds,
adds the bottom-up path aggregation. Nearest up-sampling comes later."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from nndetection_tpu_torch.models.conv import ConvNormAct, Kernel


def ufpn_out_channels(
    num_levels: int,
    decoder_levels: Optional[Sequence[int]],
    fixed_out_channels: int,
    min_out_channels: int = 8,
) -> List[int]:
    """Per-level output channels: fixed at and above ``min(decoder_levels)``,
    halving below it."""
    out = [fixed_out_channels] * num_levels
    if decoder_levels is not None:
        lowest = min(decoder_levels)
        for level in reversed(range(lowest)):
            out[level] = max(min_out_channels, out[level + 1] // 2)
    return out


def _stride_ratios(strides: Sequence[Kernel], dim: int = 3) -> List[Tuple[int, ...]]:
    s = [tuple([v] * dim) if isinstance(v, int) else tuple(v) for v in strides]
    return [
        tuple(int(b / a) for a, b in zip(s[i - 1], s[i])) for i in range(1, len(s))
    ]


class UFPN(nn.Module):
    """U-FPN over the encoder maps (high resolution first). Submodules
    ``lateral_P{level}_0`` (1x1 conv) and ``up_P{level}`` (transposed conv,
    kernel = stride = the level's stride ratio)."""

    def __init__(
        self,
        in_channels: Sequence[int],
        strides: Sequence[Kernel],
        decoder_levels: Optional[Sequence[int]],
        fixed_out_channels: int,
        min_out_channels: int = 8,
        dim: int = 3,
    ):
        super().__init__()
        self.num_levels = len(in_channels)
        out_channels = ufpn_out_channels(
            self.num_levels, decoder_levels, fixed_out_channels, min_out_channels)
        self.out_channels = out_channels
        self.ratios = _stride_ratios(strides, dim)
        for level, cin in enumerate(in_channels):
            self.add_module(f"lateral_P{level}_0", ConvNormAct(
                cin, out_channels[level], 1, norm=None, act=None, dim=dim))
            if level > 0:
                ratio = self.ratios[level - 1]
                self.add_module(f"up_P{level}", ConvNormAct(
                    out_channels[level], out_channels[level - 1], ratio, ratio,
                    norm=None, act=None, transposed=True, dim=dim))

    def top_down(self, fmaps: List[torch.Tensor]) -> List[torch.Tensor]:
        lat = [getattr(self, f"lateral_P{level}_0")(fm) for level, fm in enumerate(fmaps)]
        outs: List[Optional[torch.Tensor]] = [None] * self.num_levels
        up = None
        for level in reversed(range(self.num_levels)):
            x = lat[level]
            if up is not None:
                x = x + up
            if level > 0:
                up = getattr(self, f"up_P{level}")(x)
            outs[level] = x
        return outs

    def forward(self, fmaps: List[torch.Tensor]) -> List[torch.Tensor]:
        return self.top_down(fmaps)


class PAUFPN(UFPN):
    """U-FPN with a bottom-up path-aggregation pass after the top-down one:
    from high to low resolution, each level adds the strided conv
    ``down_P{level - 1}`` of the level above it and goes through the conv
    ``pa_fusion_P{level}_0`` (kernel ``conv_kernels[level]``, no norm, no
    activation, as the JAX package's defaults give it)."""

    def __init__(
        self,
        in_channels: Sequence[int],
        strides: Sequence[Kernel],
        conv_kernels: Sequence[Kernel],
        decoder_levels: Optional[Sequence[int]],
        fixed_out_channels: int,
        min_out_channels: int = 8,
        dim: int = 3,
    ):
        super().__init__(in_channels, strides, decoder_levels, fixed_out_channels,
                         min_out_channels, dim)
        out_channels = self.out_channels
        for level in range(self.num_levels):
            if level > 0:
                self.add_module(f"pa_fusion_P{level}_0", ConvNormAct(
                    out_channels[level], out_channels[level], conv_kernels[level],
                    norm=None, act=None, dim=dim))
            if level < self.num_levels - 1:
                self.add_module(f"down_P{level}", ConvNormAct(
                    out_channels[level], out_channels[level + 1], conv_kernels[level],
                    self.ratios[level], norm=None, act=None, dim=dim))

    def forward(self, fmaps: List[torch.Tensor]) -> List[torch.Tensor]:
        td = self.top_down(fmaps)
        outs: List[torch.Tensor] = []
        down = None
        for level in range(self.num_levels):
            x = td[level]
            if down is not None:
                x = getattr(self, f"pa_fusion_P{level}_0")(x + down)
            if level < self.num_levels - 1:
                down = getattr(self, f"down_P{level}")(x)
            outs.append(x)
        return outs
