"""Plain CNN encoder, one block per resolution stage (counterpart of
:mod:`nndetection_tpu.models.encoder`): channels double per stage from
``start_channels`` up to ``max_channels``, stage 0 unstrided."""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from nndetection_tpu_torch.models.blocks import StackedConvBlock
from nndetection_tpu_torch.models.conv import Kernel


def encoder_channels(
    num_stages: int, start_channels: int, max_channels: int = 320
) -> List[int]:
    return [min(start_channels * 2**i, max_channels) for i in range(num_stages)]


def encoder_strides(
    num_stages: int, strides: Sequence[Sequence[int]], dim: int = 3
) -> List[List[int]]:
    """Cumulative stride of each stage w.r.t. the input."""
    out = [[1] * dim]
    for i in range(1, num_stages):
        s = strides[i - 1]
        s = [s] * dim if isinstance(s, int) else list(s)
        out.append([p * q for p, q in zip(out[-1], s)])
    return out


class Encoder(nn.Module):
    """Returns one feature map per stage (highest to lowest resolution);
    stages are ``stage{i}``."""

    def __init__(
        self,
        in_channels: int,
        conv_kernels: Sequence[Kernel],
        strides: Sequence[Kernel],
        start_channels: int = 32,
        max_channels: int = 320,
        num_convs_per_stage: int = 2,
        norm: str = "instance",
        dim: int = 3,
    ):
        super().__init__()
        self.num_stages = len(conv_kernels)
        self.channels = encoder_channels(self.num_stages, start_channels, max_channels)
        prev = in_channels
        for stage in range(self.num_stages):
            self.add_module(f"stage{stage}", StackedConvBlock(
                prev,
                self.channels[stage],
                conv_kernel=conv_kernels[stage],
                stride=None if stage == 0 else strides[stage - 1],
                num_convs=num_convs_per_stage,
                norm=norm,
                dim=dim,
            ))
            prev = self.channels[stage]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = []
        for stage in range(self.num_stages):
            x = getattr(self, f"stage{stage}")(x)
            outputs.append(x)
        return outputs
