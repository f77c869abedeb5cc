"""Spatial partitioning of 3D volumes over the ``model`` group (counterpart
of :mod:`nndetection_tpu.parallel.spatial`).

For patches too large for one card, the volume is sharded along z (dim 2
of the port's ``[N, C, D, H, W]`` maps) over the ranks of a model group and
convolutions become halo-exchange convolutions: each rank trades its edge
slabs with its neighbours (point-to-point sends), then runs a local
convolution with no padding along z, whose result is its slice of the
global SAME convolution. The global edges get zero halos, as SAME padding
and the JAX package's ``ppermute`` give them.

Gradients. Every rank computes the loss on the gathered outputs, so the
collectives here *sum* the cotangents of all ranks in their backward (the
all-gather's is a reduce-scatter, the all-reduce's an all-reduce), as the
JAX package's ``shard_map`` transposes ``all_gather`` and ``psum``. Each
rank's parameter gradient is then ``n_model`` times its share; averaging
the gradients over the whole world (``("data", "model")``, DDP's mean)
gives the unpartitioned gradient, as the JAX trainer's ``pmean`` does.

The model modules consult :func:`get_spatial_axis` when they run, so the
same module tree (same parameter names, checkpoint compatible) runs
partitioned inside :func:`spatial_partitioning`. With activation
recomputation (``cfg.remat``) the forward runs again inside the backward:
keep the context open over both.

Collectives by backend: NCCL carries every one of them on cards; gloo
carries them all on CPU tensors, and on CUDA tensors all but the
point-to-point sends of the halo exchange.
"""
from __future__ import annotations

from contextlib import contextmanager
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# the partitioning context: the process group the volume's z axis is sharded
# over (None: not partitioned)
# ---------------------------------------------------------------------------
_SPATIAL_GROUP: Optional[dist.ProcessGroup] = None


def get_spatial_axis() -> Optional[dist.ProcessGroup]:
    """The model group the volume is sharded over, or None."""
    return _SPATIAL_GROUP


@contextmanager
def spatial_partitioning(group: Optional[dist.ProcessGroup] = None):
    """While active, the model modules run partitioned over ``group`` (the
    world when None): halo convs, global norms, per-level all-gathers."""
    global _SPATIAL_GROUP
    prev = _SPATIAL_GROUP
    _SPATIAL_GROUP = _group(group)
    try:
        yield
    finally:
        _SPATIAL_GROUP = prev


def _group(group):
    return group if group is not None else dist.group.WORLD


def _exchange(sends: List[Tuple[torch.Tensor, int]], recvs: List[Tuple[torch.Tensor, int]],
              group) -> None:
    """Post every send and receive (tensor, group rank) at once and wait."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, r), group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, r), group) for t, r in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class HaloExchange(torch.autograd.Function):
    """``x [..., n_local, ...]`` -> ``[..., halo_lo + n_local + halo_hi, ...]``
    along ``axis``: the low halo is the previous rank's top slab, the high
    halo the next rank's bottom slab, zeros at the global edges. The
    backward returns each halo's cotangent to the rank it came from, added
    onto that rank's edge slab."""

    @staticmethod
    def forward(ctx, x, halo_lo: int, halo_hi: int, group, axis: int):
        n, i = dist.get_world_size(group), dist.get_rank(group)
        ctx.halos, ctx.group, ctx.axis = (halo_lo, halo_hi), group, axis
        length = x.shape[axis]
        lo = x.new_zeros(x.narrow(axis, 0, halo_lo).shape)
        hi = x.new_zeros(x.narrow(axis, 0, halo_hi).shape)
        sends, recvs = [], []
        if halo_lo:
            if i + 1 < n:
                sends.append((x.narrow(axis, length - halo_lo, halo_lo).contiguous(), i + 1))
            if i > 0:
                recvs.append((lo, i - 1))
        if halo_hi:
            if i > 0:
                sends.append((x.narrow(axis, 0, halo_hi).contiguous(), i - 1))
            if i + 1 < n:
                recvs.append((hi, i + 1))
        _exchange(sends, recvs, group)
        return torch.cat([lo, x, hi], dim=axis)

    @staticmethod
    def backward(ctx, dy):
        (halo_lo, halo_hi), group, axis = ctx.halos, ctx.group, ctx.axis
        n, i = dist.get_world_size(group), dist.get_rank(group)
        length = dy.shape[axis] - halo_lo - halo_hi
        dx = dy.narrow(axis, halo_lo, length).clone()
        from_next = dy.new_zeros(dy.narrow(axis, 0, halo_lo).shape)
        from_prev = dy.new_zeros(dy.narrow(axis, 0, halo_hi).shape)
        sends, recvs = [], []
        if halo_lo:
            if i > 0:
                sends.append((dy.narrow(axis, 0, halo_lo).contiguous(), i - 1))
            if i + 1 < n:
                recvs.append((from_next, i + 1))
        if halo_hi:
            if i + 1 < n:
                sends.append((dy.narrow(axis, halo_lo + length, halo_hi).contiguous(), i + 1))
            if i > 0:
                recvs.append((from_prev, i - 1))
        _exchange(sends, recvs, group)
        if halo_lo:
            dx.narrow(axis, length - halo_lo, halo_lo).add_(from_next)
        if halo_hi:
            dx.narrow(axis, 0, halo_hi).add_(from_prev)
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, halo_lo: int, halo_hi: int, group=None,
                  spatial_axis: int = 2) -> torch.Tensor:
    """Pad the sharded axis ``spatial_axis`` of ``x`` with the neighbours'
    slabs (:class:`HaloExchange`)."""
    if not (halo_lo or halo_hi):
        return x
    return HaloExchange.apply(x, halo_lo, halo_hi, _group(group), spatial_axis)


class AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents the same way
    (JAX ``psum`` under ``shard_map`` without replication checks)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        g = dy.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    return AllReduceSum.apply(x, _group(group))


class GatherSpatial(torch.autograd.Function):
    """Concatenate the ranks' ``x`` along ``axis`` in rank order; the
    backward hands each rank the sum over ranks of its slice's cotangent (a
    reduce-scatter, done as an all-reduce and a slice: every backend carries
    it)."""

    @staticmethod
    def forward(ctx, x, group, axis: int):
        n = dist.get_world_size(group)
        ctx.group, ctx.axis, ctx.length = group, axis, x.shape[axis]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, dy):
        g = dy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.axis, i * ctx.length, ctx.length), None, None


def gather_spatial(x: torch.Tensor, group=None, spatial_axis: int = 2) -> torch.Tensor:
    """All-gather the shards back into the full volume along
    ``spatial_axis`` (the detection heads' flattened outputs, the seg map)."""
    return GatherSpatial.apply(x, _group(group), spatial_axis)


# ---------------------------------------------------------------------------
# partitioned ops, NC* layout, the volume sharded along ``spatial_axis``
# ---------------------------------------------------------------------------
def _same_halos(n_global: int, k: int, s: int) -> Tuple[int, int]:
    """(halo_lo, halo_hi) so that a local convolution without padding over
    the padded shard equals the shard's slice of the global SAME
    convolution. The shard length must divide by the stride."""
    out = -(-n_global // s)
    pad_total = max((out - 1) * s + k - n_global, 0)
    pad_lo = pad_total // 2
    return pad_lo, max(k - s - pad_lo, 0)


def _shard_halos(x: torch.Tensor, k: int, s: int, group, spatial_axis: int) -> Tuple[int, int]:
    n_local = x.shape[spatial_axis]
    if n_local % s:
        raise ValueError(f"sharded-axis shard length {n_local} not divisible by stride {s}")
    halo_lo, halo_hi = _same_halos(n_local * dist.get_world_size(group), k, s)
    if max(halo_lo, halo_hi) > n_local:
        raise ValueError(f"halo {max(halo_lo, halo_hi)} exceeds shard length {n_local}; "
                         "use fewer shards or a larger volume")
    return halo_lo, halo_hi


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` along one axis: the output has
    ``ceil(size / stride)`` positions and the odd pad goes to the high side
    (k=3, s=2 on an even size pads (0, 1), where torch's ``padding=1`` would
    pad (1, 1))."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _same_pads(x: torch.Tensor, kernel: Sequence[int], strides: Sequence[int],
               sharded: int) -> List[int]:
    """``F.pad`` list (last axis first) of SAME padding on every spatial axis
    but ``sharded`` (an index into the spatial axes)."""
    pads = [(0, 0) if d == sharded else same_padding(x.shape[2 + d], kernel[d], strides[d])
            for d in range(x.dim() - 2)]
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def spatial_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 strides: Sequence[int] = (1, 1, 1), group=None,
                 spatial_axis: int = 2) -> torch.Tensor:
    """SAME convolution of a volume sharded along ``spatial_axis``: ``x``
    the local shard ``[N, C_in, D, H, W]``, ``weight [C_out, C_in, kd, kh,
    kw]``. Halo exchange along the sharded axis, SAME padding on the others,
    then a local convolution without padding."""
    group = _group(group)
    strides = tuple(int(s) for s in strides)
    sp = spatial_axis - 2
    kernel = tuple(weight.shape[2:])
    halo_lo, halo_hi = _shard_halos(x, kernel[sp], strides[sp], group, spatial_axis)
    x = halo_exchange(x, halo_lo, halo_hi, group, spatial_axis)
    x = F.pad(x, _same_pads(x, kernel, strides, sp))
    return F.conv3d(x, weight, bias, strides)


def spatial_transposed_conv(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            strides: Sequence[int] = (2, 2, 2)) -> torch.Tensor:
    """Transposed convolution with kernel == stride (the decoder's
    up-sampling), ``weight [C_in, C_out, *k]``: each output voxel reads one
    input voxel, so the op is local."""
    if tuple(weight.shape[2:]) != tuple(strides):
        raise NotImplementedError(
            "sharded transposed conv supports kernel == stride (the U-FPN up-sampler); "
            f"got kernel {tuple(weight.shape[2:])} stride {tuple(strides)}")
    return F.conv_transpose3d(x, weight, bias, tuple(strides))


def spatial_group_norm(x: torch.Tensor, num_groups: int, weight: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                       group=None) -> torch.Tensor:
    """Group norm whose statistics span the global volume: the float32 sums
    over (channels of the group, local voxels) summed over the ranks,
    centred variance as the JAX package computes it."""
    group = _group(group)
    n, c = x.shape[:2]
    xg = x.reshape(n, num_groups, -1)
    count = xg.shape[-1] * dist.get_world_size(group)
    mean = all_reduce_sum(xg.float().sum(-1, keepdim=True), group) / count
    diff = xg - mean.to(x.dtype)
    var = all_reduce_sum(diff.float().square().sum(-1, keepdim=True), group) / count
    y = (diff * torch.rsqrt(var + eps).to(x.dtype)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    if weight is not None:
        y = y * weight.to(y.dtype).reshape(shape)
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(shape)
    return y


def spatial_max_pool(x: torch.Tensor, window: Sequence[int],
                     strides: Optional[Sequence[int]] = None, group=None,
                     spatial_axis: int = 2) -> torch.Tensor:
    """SAME max pooling of a sharded volume. The halos come with a validity
    mask, so that the global edges pool over ``-inf``, not the exchange's
    zeros."""
    group = _group(group)
    window = tuple(int(w) for w in window)
    strides = tuple(int(s) for s in (strides or window))
    sp = spatial_axis - 2
    halo_lo, halo_hi = _shard_halos(x, window[sp], strides[sp], group, spatial_axis)
    if halo_lo or halo_hi:
        valid = halo_exchange(torch.ones_like(x), halo_lo, halo_hi, group, spatial_axis)
        x = halo_exchange(x, halo_lo, halo_hi, group, spatial_axis)
        x = torch.where(valid > 0, x, torch.full_like(x, -torch.inf))
    x = F.pad(x, _same_pads(x, window, strides, sp), value=-torch.inf)
    return F.max_pool3d(x, window, strides)
