"""Conv block (counterpart of :class:`nndetection_tpu.models.blocks.StackedConvBlock`;
the residual and squeeze-excitation blocks come later)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nndetection_tpu_torch.models.conv import ConvNormAct, Kernel


class StackedConvBlock(nn.Module):
    """``num_convs`` conv-norm-act layers (``ConvNormAct_{i}``); the first
    carries the stage stride."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        conv_kernel: Kernel = 3,
        stride: Optional[Kernel] = None,
        num_convs: int = 2,
        norm: str = "instance",
        act: str = "relu",
    ):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"ConvNormAct_{i}", ConvNormAct(
                in_channels if i == 0 else out_channels,
                out_channels,
                kernel_size=conv_kernel,
                strides=stride if (i == 0 and stride is not None) else 1,
                norm=norm,
                act=act,
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"ConvNormAct_{i}")(x)
        return x
