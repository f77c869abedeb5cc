"""Conv block families (counterpart of :mod:`nndetection_tpu.models.blocks`):
the stacked conv block of every plan, and the residual and
squeeze-excitation blocks, which no plan builds."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nndetection_tpu_torch.models.conv import ConvNormAct, Kernel, _init_kernel
from nndetection_tpu_torch.parallel.spatial import all_reduce_sum, get_spatial_axis


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
        dim: int = 3,
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
                dim=dim,
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"ConvNormAct_{i}")(x)
        return x


class StackedResidualBlock(nn.Module):
    """``num_convs`` conv-norm layers (``ConvNormAct_{i}``, the last without
    activation) plus the input, then ReLU. Where the channels change or the
    block strides, the shortcut is a strided 1x1 conv and norm, the next
    ``ConvNormAct_{num_convs}``, as flax numbers it."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        conv_kernel: Kernel = 3,
        stride: Optional[Kernel] = None,
        num_convs: int = 2,
        norm: str = "instance",
        act: str = "relu",
        dim: int = 3,
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
                act=None if i == num_convs - 1 else act,
                dim=dim,
            ))
        strides = [stride] if isinstance(stride, int) else list(stride or [])
        self.projected = in_channels != out_channels or any(s != 1 for s in strides)
        if self.projected:
            self.add_module(f"ConvNormAct_{num_convs}", ConvNormAct(
                in_channels, out_channels, kernel_size=1,
                strides=stride if stride is not None else 1, norm=norm, act=None, dim=dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.num_convs):
            y = getattr(self, f"ConvNormAct_{i}")(y)
        identity = getattr(self, f"ConvNormAct_{self.num_convs}")(x) if self.projected else x
        return torch.relu(y + identity)


class SELayer(nn.Module):
    """Squeeze-and-excitation: the float32 spatial mean of each channel
    through two dense layers (``Dense_0``, ReLU, ``Dense_1``, sigmoid)
    scales the channels. The dense layers run in the input's type."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(1, channels // reduction)
        self.Dense_0 = nn.Linear(channels, hidden)
        self.Dense_1 = nn.Linear(hidden, channels)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # flax's Dense: lecun-normal kernel, zero bias
        for dense in (self.Dense_0, self.Dense_1):
            _init_kernel(dense.weight.data, "lecun_normal", dense.in_features, generator)
            dense.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def dense(layer: nn.Linear, v: torch.Tensor) -> torch.Tensor:
            return F.linear(v, layer.weight.to(x.dtype), layer.bias.to(x.dtype))

        s = x.float().mean(dim=tuple(range(2, x.dim())))
        group = get_spatial_axis()
        if group is not None:
            # the squeeze spans the global volume under spatial partitioning
            s = all_reduce_sum(s, group) / torch.distributed.get_world_size(group)
        s = s.to(x.dtype)
        s = torch.sigmoid(dense(self.Dense_1, torch.relu(dense(self.Dense_0, s))))
        return x * s.reshape(*s.shape, *([1] * (x.dim() - 2)))
