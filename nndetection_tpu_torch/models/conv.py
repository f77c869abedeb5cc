"""Conv/norm/act building blocks (counterpart of
:mod:`nndetection_tpu.models.conv`), 2D and 3D.

Activations are ``[B, C, D, H, W]`` tensors in ``torch.channels_last_3d``
memory (``[B, C, H, W]`` in ``torch.channels_last`` for 2D models), so that
the channel axis is innermost as in the JAX package's NDHWC / NHWC layout and
the instance-norm kernels read ``[B, S, C]`` maps without a copy.
Convolutions are ``F.conv3d``/``F.conv_transpose3d`` or their 2D versions,
by the weight's rank (the JAX package leaves every default conv to XLA);
the instance norm always runs through the kernels of
:mod:`nndetection_tpu_torch.ops.instance_norm`, forward and backward, by
way of its ``torch.autograd.Function``. Under ``NNDET_CONV_FUSED=1`` a
``ConvNormAct`` whose conv and norm the JAX package fuses runs both through
:mod:`nndetection_tpu_torch.ops.conv_in_stats` instead: the fused conv
kernel with exact statistics, then the apply.

Parameters are float32 and cast to the activation type at use, as flax does
with ``param_dtype=float32``. Submodules carry the flax scope names
(``Conv_0``, ``ConvTranspose_0``, ``InstanceNorm_0``, ``GroupNorm_0``) so that
a flax parameter tree maps onto the ``state_dict`` by renaming leaves
(:mod:`nndetection_tpu_torch.bridge`).

Inside :func:`nndetection_tpu_torch.parallel.spatial.spatial_partitioning`
the same modules, with the same parameters, run on a z-slab of the volume:
a 3D ``Conv`` exchanges halos with its neighbours, the norms take the
statistics of the global volume, the fused conv is off (as in the JAX
package, ``models/conv.py:37-100, 288-305, 375-420, 466-475``). A
transposed conv with kernel == stride reads one input voxel per output
voxel, so it runs as it is.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from nndetection_tpu_torch.ops import conv_in_stats
from nndetection_tpu_torch.ops.instance_norm import instance_norm, spatial_instance_norm
from nndetection_tpu_torch.parallel.spatial import (
    get_spatial_axis,
    same_padding,
    spatial_conv,
    spatial_group_norm,
)

Kernel = Union[int, Sequence[int]]


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the channel-innermost memory format of its rank."""
    return x.contiguous(
        memory_format=torch.channels_last_3d if x.dim() == 5 else torch.channels_last)


def _to_tuple(k: Kernel, dim: int = 3) -> Tuple[int, ...]:
    if isinstance(k, int):
        return (k,) * dim
    return tuple(int(v) for v in k)


def _init_kernel(w: torch.Tensor, init: str, fan_in: int, generator) -> None:
    """flax's initializers: ``he_normal``/``lecun_normal`` are truncated
    normals (at 2 std) with variance 2/fan_in resp. 1/fan_in, corrected for
    the truncation; ``normal_0.01`` is a plain normal."""
    if init == "normal_0.01":
        nn.init.normal_(w, 0.0, 0.01, generator=generator)
        return
    scale = {"he_normal": 2.0, "lecun_normal": 1.0}[init]
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Conv(nn.Module):
    """``nn.Conv(padding="SAME")`` of flax: weight ``[Co, Ci, *k]``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Kernel,
        strides: Kernel = 1,
        use_bias: bool = True,
        init: str = "he_normal",
        bias_value: float = 0.0,
        dim: int = 3,
    ):
        super().__init__()
        self.kernel_size = _to_tuple(kernel_size, dim)
        self.strides = _to_tuple(strides, dim)
        self.init = init
        self.bias_value = bias_value
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_kernel(self.weight.data, self.init, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.data.fill_(self.bias_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        group = get_spatial_axis()
        if group is not None and self.weight.dim() == 5:
            return channels_last(
                spatial_conv(x, self.weight.to(x.dtype), bias, self.strides, group))
        pads = [same_padding(n, k, s) for n, k, s in
                zip(x.shape[2:], self.kernel_size, self.strides)]
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            # asymmetric SAME: pad explicitly (F.pad lists the last axis first)
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        conv = F.conv3d if self.weight.dim() == 5 else F.conv2d
        return channels_last(conv(x, self.weight.to(x.dtype), bias, self.strides, padding))


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose(padding="SAME")`` of flax for kernel == stride (the
    decoder's up-sampling): weight ``[Ci, Co, *k]``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Kernel,
                 strides: Kernel, use_bias: bool = True, dim: int = 3):
        super().__init__()
        self.kernel_size = _to_tuple(kernel_size, dim)
        self.strides = _to_tuple(strides, dim)
        if self.kernel_size != self.strides:
            raise NotImplementedError(
                f"transposed conv with kernel {self.kernel_size} != stride {self.strides}")
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight.shape[0] * math.prod(self.kernel_size)
        _init_kernel(self.weight.data, "he_normal", fan_in, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        conv = F.conv_transpose3d if self.weight.dim() == 5 else F.conv_transpose2d
        return channels_last(conv(x, self.weight.to(x.dtype), bias, self.strides))


def in_plane_stride(ndim: int) -> Optional[int]:
    """Depth-plane stride of the instance-norm statistics, by the JAX
    package's rule (``models/conv.py:332-340``): ``NNDET_IN_STATS`` set to
    ``plane_sub[:k]`` samples every k-th plane (k = 4 when omitted); any other
    value gives exact statistics; unset, 5-D maps use ``plane_sub:8``."""
    impl = os.environ.get("NNDET_IN_STATS", "plane_sub:8" if ndim == 5 else "two_pass")
    if impl.startswith("plane_sub"):
        return int(impl.split(":")[1]) if ":" in impl else 4
    return None


def conv_fused() -> bool:
    """The JAX package's configuration switch of the fused conv
    (``models/conv.py:469-485``), read at call time."""
    return os.environ.get("NNDET_CONV_FUSED") == "1"


class InstanceNorm(nn.Module):
    """Instance norm over the spatial axes, float32 statistics, through the
    instance-norm kernels and their ``torch.autograd.Function`` on every
    device. Parameters ``weight`` (flax ``scale``) and ``bias``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # [B, C, *spatial] in channel-innermost memory is a contiguous
        # [B, *spatial, C] map once the channel axis is moved last
        group = get_spatial_axis()
        if group is not None:
            y = spatial_instance_norm(x.movedim(1, -1), self.weight, self.bias, self.eps, group)
            return y.movedim(-1, 1)
        y = instance_norm(
            x.movedim(1, -1), self.weight, self.bias, self.eps,
            plane_stride=in_plane_stride(x.dim()),
        )
        return y.movedim(-1, 1)


class GroupNorm(nn.Module):
    """Group norm with ``channels // channels_per_group`` contiguous groups.
    The parameters sit one scope deeper, as flax nests its ``nn.GroupNorm``
    (``GroupNorm_0/GroupNorm_0/{scale,bias}``)."""

    def __init__(self, channels: int, channels_per_group: int = 16, eps: float = 1e-5):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(max(1, channels // channels_per_group), channels, eps)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.GroupNorm_0.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gn = self.GroupNorm_0
        group = get_spatial_axis()
        if group is not None:
            return channels_last(spatial_group_norm(x, gn.num_groups, gn.weight, gn.bias, gn.eps,
                                                    group))
        return channels_last(
            F.group_norm(x, gn.num_groups, gn.weight.to(x.dtype), gn.bias.to(x.dtype), gn.eps))


class ConvNormAct(nn.Module):
    """conv -> (norm) -> (act); bias only when no norm follows. ``act`` is
    ``"relu"``, ``"leaky_relu"`` (slope 0.01) or None.

    Under ``NNDET_CONV_FUSED=1`` an instance-normed, untransposed conv that
    :func:`conv_in_stats.supported` accepts runs conv and norm as one
    :class:`~nndetection_tpu_torch.ops.conv_in_stats.ConvInstanceNormFunction`:
    the conv in bf16 whatever the model's type, exact statistics from its
    epilogue, the norm in the input's type. The parameters are the same."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Kernel = 3,
        strides: Kernel = 1,
        norm: Optional[str] = "instance",
        act: Optional[str] = "relu",
        norm_channels_per_group: int = 16,
        transposed: bool = False,
        dim: int = 3,
    ):
        super().__init__()
        use_bias = norm is None
        if transposed:
            self.ConvTranspose_0 = ConvTranspose(
                in_channels, out_channels, kernel_size, strides, use_bias, dim=dim)
        else:
            self.Conv_0 = Conv(in_channels, out_channels, kernel_size, strides, use_bias, dim=dim)
        if norm == "instance":
            self.InstanceNorm_0 = InstanceNorm(out_channels)
        elif norm == "group":
            self.GroupNorm_0 = GroupNorm(out_channels, norm_channels_per_group)
        elif norm is not None:
            raise ValueError(f"unknown norm {norm}")
        if act not in ("relu", "leaky_relu", None):
            raise ValueError(f"unknown act {act}")
        self.transposed, self.norm, self.act = transposed, norm, act

    def _fused(self, x: torch.Tensor) -> bool:
        # supported() takes 3D convs only, as in the JAX package
        return (conv_fused() and self.norm == "instance" and not self.transposed
                and get_spatial_axis() is None
                and conv_in_stats.supported(
                    (x.shape[0], *x.shape[2:], x.shape[1]), self.Conv_0.kernel_size,
                    self.Conv_0.strides, x.dim() - 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fused(x):
            norm = self.InstanceNorm_0
            x = conv_in_stats.conv_instance_norm(
                x.permute(0, 2, 3, 4, 1), self.Conv_0.weight, norm.weight, norm.bias, norm.eps,
                out_dtype=x.dtype,
            ).permute(0, 4, 1, 2, 3)
        else:
            x = self.ConvTranspose_0(x) if self.transposed else self.Conv_0(x)
            if self.norm == "instance":
                x = self.InstanceNorm_0(x)
            elif self.norm == "group":
                x = self.GroupNorm_0(x)
        if self.act == "relu":
            x = torch.relu_(x)
        elif self.act == "leaky_relu":
            x = F.leaky_relu_(x, 0.01)
        return x
