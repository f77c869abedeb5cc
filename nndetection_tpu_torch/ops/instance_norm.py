"""Instance norm forward over channel-last maps: the counterpart of
``nndetection_tpu/ops/pallas_norm.py::fused_instance_norm`` (forward only).

Two Triton kernels, each beside its plain PyTorch version:

* :func:`in_stats` replaces ``_stats_kernel`` (``pallas_norm.py:72``): the
  per-(b, c) mean and biased variance of ``x [B, D, Q, C]`` over the depth
  planes ``start, start + step, ...`` and all ``Q`` in-plane positions.
  ``step = 1`` gives the exact statistics of ``fused_instance_norm``; a
  stride gives the JAX package's ``plane_sub`` estimator
  (``models/conv.py:199-240``).
* :func:`in_apply` replaces ``_apply_kernel`` (``pallas_norm.py:105``):
  ``y = (x - mean) * scale + beta`` with ``scale = rsqrt(var + eps) * gamma``
  folded in, computed in float32 and stored in x's type.

What bounds both on the H100: memory bandwidth. Each is one pass over the
map (the stats read it, the apply reads and writes it) with a few flops per
element, far below the card's ~295 flops/byte balance point. The design is
therefore coalescing and occupancy: C, the contiguous axis, is the inner
block axis (a row of 32-64 channels is one 64-128 B segment), blocks of
``[BLOCK_R, BLOCK_C]`` keep 8K elements in flight per program, and the stats
pass splits the spatial rows over enough programs to fill all SMs. The TPU
kernel carries its running mean/M2 from one grid step to the next; blocks on
the card run in parallel, so each program keeps its own Chan-combined
partials over its rows and a second, tiny kernel combines the
``[B, splits, C]`` partials in one launch (a PyTorch reduction there would
take a dozen).

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from nndetection_tpu_torch.ops import LAUNCHES

# ``triton.language``, imported at the first launch: hosts without a card
# have no triton, and importing this module must not need it
tl = None
_kernels = None

# elements of one [BLOCK_R, BLOCK_C] block, programs per SM the stats pass
# aims for, and partials the combine pass reads per step
_BLOCK_ELEMS = 8192
_PROGRAMS_PER_SM = 8
_COMBINE_SPLITS = 64


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _in_stats_kernel(
    x_ptr, mean_ptr, m2_ptr, Q, C, start, step, n_rows, rows_per_split,
    batch_stride, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
):
    # partial (mean, M2) of one (split, b, channel block) over its rows of
    # the selected planes, Chan-combined block by block
    sp = tl.program_id(0)
    b = tl.program_id(1)
    cb = tl.program_id(2)
    n_splits = tl.num_programs(0)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    r_begin = sp * rows_per_split
    r_end = tl.minimum(r_begin + rows_per_split, n_rows)
    base = x_ptr + b.to(tl.int64) * batch_stride
    count = tl.zeros([BLOCK_C], dtype=tl.float32)
    mean = tl.zeros([BLOCK_C], dtype=tl.float32)
    m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
    for r0 in range(r_begin, r_end, BLOCK_R):
        rows = r0 + tl.arange(0, BLOCK_R)
        rmask = rows < r_end
        plane = rows // Q
        q = rows - plane * Q
        off = ((start + plane * step).to(tl.int64) * Q + q) * C
        mask = rmask[:, None] & cmask[None, :]
        x = tl.load(base + off[:, None] + cols[None, :], mask=mask, other=0.0)
        x = x.to(tl.float32)
        nb = tl.sum(rmask.to(tl.float32), axis=0)
        mb = tl.sum(x, axis=0) / nb
        d = tl.where(mask, x - mb[None, :], 0.0)
        m2b = tl.sum(d * d, axis=0)
        tot = count + nb
        delta = mb - mean
        mean = mean + delta * (nb / tot)
        m2 = m2 + m2b + delta * delta * (count * nb / tot)
        count = tot
    out = (b * n_splits + sp) * C + cols
    tl.store(mean_ptr + out, mean, mask=cmask)
    tl.store(m2_ptr + out, m2, mask=cmask)


def _in_combine_kernel(
    part_mean_ptr, part_m2_ptr, mean_ptr, var_ptr, n_splits, C, rows_per_split,
    n_rows, BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
):
    # combines the [n_splits] partials of one (b, channel block) with Chan's
    # parallel formula, BLOCK_S splits at a time: mean = sum(n_s m_s) / N,
    # M2 = sum(M2_s + n_s (m_s - mean)^2). Every split holds rows_per_split
    # rows except the last. (A serial loop over the splits, one dependent
    # load each, took as long as the stats pass itself.)
    b = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mean = tl.zeros([BLOCK_C], dtype=tl.float32)
    for s0 in range(0, n_splits, BLOCK_S):
        sp = s0 + tl.arange(0, BLOCK_S)
        smask = sp < n_splits
        nb = tl.where(smask, tl.minimum(rows_per_split, n_rows - sp * rows_per_split), 0)
        off = (b * n_splits + sp[:, None]) * C + cols[None, :]
        mb = tl.load(part_mean_ptr + off, mask=smask[:, None] & cmask[None, :], other=0.0)
        mean += tl.sum(mb * (nb.to(tl.float32) / n_rows)[:, None], axis=0)
    m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
    for s0 in range(0, n_splits, BLOCK_S):
        sp = s0 + tl.arange(0, BLOCK_S)
        smask = sp < n_splits
        nb = tl.where(smask, tl.minimum(rows_per_split, n_rows - sp * rows_per_split), 0)
        off = (b * n_splits + sp[:, None]) * C + cols[None, :]
        mask = smask[:, None] & cmask[None, :]
        mb = tl.load(part_mean_ptr + off, mask=mask, other=0.0)
        m2b = tl.load(part_m2_ptr + off, mask=mask, other=0.0)
        d = tl.where(mask, mb - mean[None, :], 0.0)
        m2 += tl.sum(m2b + nb.to(tl.float32)[:, None] * d * d, axis=0)
    tl.store(mean_ptr + b * C + cols, mean, mask=cmask)
    tl.store(var_ptr + b * C + cols, m2 / n_rows, mask=cmask)


def _in_apply_kernel(
    x_ptr, y_ptr, mean_ptr, var_ptr, gamma_ptr, beta_ptr, eps, S, C,
    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
):
    # y = (x - mean[b]) * (rsqrt(var[b] + eps) * gamma) + beta over one
    # [BLOCK_R, BLOCK_C] block
    rb = tl.program_id(0)
    b = tl.program_id(1)
    cb = tl.program_id(2)
    rows = rb * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < S)[:, None] & cmask[None, :]
    off = (b.to(tl.int64) * S + rows[:, None]) * C + cols[None, :]
    x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    mean = tl.load(mean_ptr + b * C + cols, mask=cmask, other=0.0)
    var = tl.load(var_ptr + b * C + cols, mask=cmask, other=0.0)
    gamma = tl.load(gamma_ptr + cols, mask=cmask, other=0.0)
    beta = tl.load(beta_ptr + cols, mask=cmask, other=0.0)
    scale = tl.rsqrt(var + eps) * gamma
    y = (x - mean[None, :]) * scale[None, :] + beta[None, :]
    tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=mask)


def _triton():
    global tl, _kernels
    if _kernels is None:
        import triton
        import triton.language

        tl = triton.language
        _kernels = (triton, triton.jit(_in_stats_kernel), triton.jit(_in_combine_kernel),
                    triton.jit(_in_apply_kernel))
    return _kernels


def _blocks(c: int) -> Tuple[int, int]:
    block_c = min(64, 1 << max(c - 1, 0).bit_length())
    return _BLOCK_ELEMS // block_c, block_c


def _check_map(x4: torch.Tensor, name: str) -> None:
    if x4.dim() != 4:
        raise ValueError(f"{name} takes x [B, D, Q, C], got shape {tuple(x4.shape)}")
    if x4.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{name} takes float32/bfloat16/float16, got {x4.dtype}")
    if not x4.is_contiguous():
        raise ValueError(f"{name} takes a contiguous channel-last map")


def _check_stat(t: torch.Tensor, shape, x4: torch.Tensor, name: str) -> None:
    if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32 {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != x4.device:
        raise ValueError(f"{name}: tensors on different devices")


# ----------------------------------------------------------------- stats
def in_stats_plain(
    x4: torch.Tensor, start: int = 0, step: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(b, c) float32 mean and biased variance of ``x4 [B, D, Q, C]``
    over depth planes ``start::step`` (two-pass, centered)."""
    sel = x4[:, start::step].float()
    mean = sel.mean(dim=(1, 2))
    var = (sel - mean[:, None, None]).square().mean(dim=(1, 2))
    return mean, var


def _in_stats_cuda(x4, start, step):
    _check_map(x4, "in_stats")
    triton, stats_kernel, combine_kernel, _ = _triton()
    b, d, q, c = x4.shape
    n_rows = len(range(start, d, step)) * q
    if n_rows == 0:
        raise ValueError(f"in_stats: no plane selected by {start}::{step} of {d}")
    block_r, block_c = _blocks(c)
    n_cb = triton.cdiv(c, block_c)
    n_splits = max(1, min(triton.cdiv(_PROGRAMS_PER_SM * _sm_count(x4.device), b * n_cb),
                          triton.cdiv(n_rows, block_r)))
    rows_per_split = triton.cdiv(triton.cdiv(n_rows, n_splits), block_r) * block_r
    n_splits = triton.cdiv(n_rows, rows_per_split)
    # one allocation for both partials and one for both results
    part = torch.empty((2, b, n_splits, c), dtype=torch.float32, device=x4.device)
    mean, var = torch.empty((2, b, c), dtype=torch.float32, device=x4.device)
    with torch.cuda.device(x4.device):
        stats_kernel[(n_splits, b, n_cb)](
            x4, part[0], part[1], q, c, start, step, n_rows, rows_per_split,
            d * q * c, BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8,
        )
        combine_kernel[(b, n_cb)](
            part[0], part[1], mean, var, n_splits, c, rows_per_split, n_rows,
            BLOCK_S=_COMBINE_SPLITS, BLOCK_C=block_c, num_warps=4,
        )
    LAUNCHES["in_stats"] += 1
    return mean, var


def in_stats(
    x4: torch.Tensor, start: int = 0, step: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatching wrapper of :func:`in_stats_plain` (CPU) and the Triton
    stats kernel (CUDA)."""
    if x4.device.type == "cpu":
        return in_stats_plain(x4, start, step)
    if x4.device.type == "cuda":
        return _in_stats_cuda(x4, start, step)
    raise NotImplementedError(f"in_stats has no kernel for {x4.device}")


# ----------------------------------------------------------------- apply
def in_apply_plain(
    x4: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, gamma: torch.Tensor,
    beta: torch.Tensor, eps: float = 1e-5,
) -> torch.Tensor:
    """``(x - mean[b]) * (rsqrt(var[b] + eps) * gamma) + beta`` in float32,
    stored in x's type."""
    scale = torch.rsqrt(var + eps) * gamma
    y = (x4.float() - mean[:, None, None]) * scale[:, None, None] + beta
    return y.to(x4.dtype)


def _in_apply_cuda(x4, mean, var, gamma, beta, eps):
    _check_map(x4, "in_apply")
    b, d, q, c = x4.shape
    _check_stat(mean, (b, c), x4, "in_apply mean")
    _check_stat(var, (b, c), x4, "in_apply var")
    _check_stat(gamma, (c,), x4, "in_apply gamma")
    _check_stat(beta, (c,), x4, "in_apply beta")
    triton, _, _, apply_kernel = _triton()
    s = d * q
    block_r, block_c = _blocks(c)
    y = torch.empty_like(x4)
    grid = (triton.cdiv(s, block_r), b, triton.cdiv(c, block_c))
    with torch.cuda.device(x4.device):
        apply_kernel[grid](
            x4, y, mean, var, gamma, beta, eps, s, c,
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8,
        )
    LAUNCHES["in_apply"] += 1
    return y


def in_apply(
    x4: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, gamma: torch.Tensor,
    beta: torch.Tensor, eps: float = 1e-5,
) -> torch.Tensor:
    """Dispatching wrapper of :func:`in_apply_plain` (CPU) and the Triton
    apply kernel (CUDA). ``mean``/``var [B, C]``, ``gamma``/``beta [C]``,
    all float32."""
    if x4.device.type == "cpu":
        return in_apply_plain(x4, mean, var, gamma, beta, eps)
    if x4.device.type == "cuda":
        return _in_apply_cuda(x4, mean, var, gamma, beta, eps)
    raise NotImplementedError(f"in_apply has no kernel for {x4.device}")


# ------------------------------------------------------------ composite
def _instance_norm(x, gamma, beta, eps, plane_stride, stats_fn, apply_fn):
    b, d, c = x.shape[0], x.shape[1], x.shape[-1]
    q = math.prod(x.shape[2:-1])
    x4 = x.view(b, d, q, c)
    start, step = plane_schedule(d, plane_stride)
    mean, var = stats_fn(x4, start, step)
    return apply_fn(x4, mean, var, gamma, beta, eps).view(x.shape)


def plane_schedule(depth: int, plane_stride: Optional[int]) -> Tuple[int, int]:
    """``(start, step)`` of the depth planes the statistics read: every
    ``plane_stride``-th plane from ``plane_stride // 2`` (the JAX package's
    ``plane_sub`` estimator), or all planes when there is no stride or the
    depth is below ``2 * plane_stride``."""
    if plane_stride is None or depth < 2 * plane_stride:
        return 0, 1
    return plane_stride // 2, plane_stride


def instance_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-5,
    plane_stride: Optional[int] = None,
) -> torch.Tensor:
    """Instance norm of a channel-last map ``x [B, D, *spatial, C]`` with
    ``gamma``/``beta [C]``; statistics over the planes of
    :func:`plane_schedule`. Output in x's type."""
    return _instance_norm(x, gamma, beta, eps, plane_stride, in_stats, in_apply)


def instance_norm_plain(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-5,
    plane_stride: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`instance_norm`."""
    return _instance_norm(
        x, gamma, beta, eps, plane_stride, in_stats_plain, in_apply_plain
    )
