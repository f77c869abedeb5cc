"""U-FPN decoder (counterpart of :class:`nndetection_tpu.models.decoder.UFPN`
with its defaults: one 1x1 lateral conv per level, transposed-conv
up-sampling, no fusion or out convs). ``PAUFPN`` and nearest up-sampling come
later."""
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
    ):
        super().__init__()
        self.num_levels = len(in_channels)
        out_channels = ufpn_out_channels(
            self.num_levels, decoder_levels, fixed_out_channels, min_out_channels)
        self.out_channels = out_channels
        ratios = _stride_ratios(strides)
        for level, cin in enumerate(in_channels):
            self.add_module(f"lateral_P{level}_0", ConvNormAct(
                cin, out_channels[level], 1, norm=None, act=None))
            if level > 0:
                ratio = ratios[level - 1]
                self.add_module(f"up_P{level}", ConvNormAct(
                    out_channels[level], out_channels[level - 1], ratio, ratio,
                    norm=None, act=None, transposed=True))

    def forward(self, fmaps: List[torch.Tensor]) -> List[torch.Tensor]:
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
