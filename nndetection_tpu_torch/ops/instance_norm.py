"""Instance norm over channel-last maps: the counterpart of
``nndetection_tpu/ops/pallas_norm.py::fused_instance_norm``, forward and
backward.

Four kernels, each beside its plain PyTorch version:

* :func:`in_stats` replaces ``_stats_kernel`` (``pallas_norm.py:72``): the
  per-(b, c) mean and biased variance of ``x [B, D, Q, C]`` over the depth
  planes ``start, start + step, ...`` and all ``Q`` in-plane positions.
  ``step = 1`` gives the exact statistics of ``fused_instance_norm``; a
  stride gives the JAX package's ``plane_sub`` estimator
  (``models/conv.py:199-240``). CUDA C++ (``csrc/instance_norm_stats.cu``):
  one launch, whose last block per (b, channel block) combines the
  partials; :func:`plan_in_stats` sizes its grid.
* :func:`in_apply` replaces ``_apply_kernel`` (``pallas_norm.py:105``):
  ``y = (x - mean) * scale + beta`` with ``scale = rsqrt(var + eps) * gamma``
  folded in, computed in float32 and stored in x's type. Triton.
* :func:`in_grad_stats` replaces ``_grad_stats_kernel``
  (``pallas_norm.py:115``): ``s1 = sum(dy)`` and ``s2 = sum(dy * xhat)`` per
  (b, c) over every voxel, ``xhat = (x - mean) * inv``. Triton.
* :func:`in_grad_input` replaces ``_dx_kernel`` (``pallas_norm.py:135``):
  ``dx = gamma * inv * (dy - [plane in P] * (s1 + xhat * s2) / |P|)``, where
  ``P`` are the planes the statistics read. With ``step = 1`` this is the
  Pallas kernel's formula; with a stride it is the gradient ``jax.grad``
  takes through the plane-subsampled statistics, whose mean and variance
  depend on the sampled planes only. Triton.

:class:`InstanceNormFunction` ties them into one ``torch.autograd.Function``
(the counterpart of the Pallas ``custom_vjp``), on every device.

What bounds all four on the H100: memory bandwidth at the large stages, the
launch at the small ones. Each is one pass over the map (the stats read the
selected planes, the apply reads and writes the map, the gradient sums read
``x`` and ``dy``, the input gradient reads both and writes ``dx``) with a few
flops per element, far below the card's ~295 flops/byte balance point. The
design is therefore coalescing and occupancy: C, the contiguous axis, is the
inner block axis (a row of 32-64 channels is one 64-128 B segment), and the
reductions split the spatial rows over enough blocks to fill all SMs. The
TPU kernels carry their running sums from one grid step to the next; blocks
on the card run in parallel, so each keeps its own partials over its rows,
and the partials are combined in a fixed order (the gradient sums in a
second, tiny kernel; the statistics by the last block to arrive): no float
atomics, so two runs give the same bits.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from nndetection_tpu_torch.ops import LAUNCHES, _build

# ``triton.language``, imported at the first launch: hosts without a card
# have no triton, and importing this module must not need it
tl = None
_kernels = None

# elements of one [BLOCK_R, BLOCK_C] block, programs per SM the gradient-sum
# pass aims for, and partials its combine pass reads per step
_BLOCK_ELEMS = 8192
_PROGRAMS_PER_SM = 8
_COMBINE_SPLITS = 64

# the statistics kernel's geometry, read from its source
# (csrc/instance_norm_stats.cu): channels per block at most, resident blocks
# per SM (its grid is one wave of them), and its threads per block and
# partials per thread in the combine, which bound the splits
_IN_STATS_GEO = _build.constants("instance_norm_stats.cu")
IN_STATS_CB = _IN_STATS_GEO["kMaxCB"]
IN_STATS_BLOCKS_PER_SM = _IN_STATS_GEO["kBlocksPerSm"]
IN_STATS_THREADS = _IN_STATS_GEO["kThreads"]
IN_STATS_HOLD = _IN_STATS_GEO["kHold"]
# the plan's own choice: fewest selected rows per split
IN_STATS_MIN_ROWS = 128
# dtype codes of its C entry point
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_stats_fn = None
# partials and arrival counters of the statistics kernel, one buffer per
# (device, stream), grown on demand. The counters are zeroed once, when
# allocated, and every launch leaves them at zero (the last block of each
# (b, channel block) resets its own). Calls on one stream run in order, so
# they share a buffer; calls on two streams must not, hence the key.
_stats_ws: dict = {}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _in_grad_stats_kernel(
    x_ptr, dy_ptr, mean_ptr, inv_ptr, p1_ptr, p2_ptr, S, C, rows_per_split,
    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
):
    # partial sum(dy) and sum(dy * xhat) of one (split, b, channel block)
    # over its rows, kept elementwise and reduced once at the end
    sp = tl.program_id(0)
    b = tl.program_id(1)
    cb = tl.program_id(2)
    n_splits = tl.num_programs(0)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mean = tl.load(mean_ptr + b * C + cols, mask=cmask, other=0.0)
    inv = tl.load(inv_ptr + b * C + cols, mask=cmask, other=0.0)
    r_begin = sp * rows_per_split
    r_end = tl.minimum(r_begin + rows_per_split, S)
    base = b.to(tl.int64) * S * C
    acc1 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
    for r0 in range(r_begin, r_end, BLOCK_R):
        rows = r0 + tl.arange(0, BLOCK_R)
        mask = (rows < r_end)[:, None] & cmask[None, :]
        off = base + rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + off, mask=mask, other=0.0).to(tl.float32)
        acc1 += dy
        acc2 += dy * ((x - mean[None, :]) * inv[None, :])
    out = (b * n_splits + sp) * C + cols
    tl.store(p1_ptr + out, tl.sum(acc1, axis=0), mask=cmask)
    tl.store(p2_ptr + out, tl.sum(acc2, axis=0), mask=cmask)


def _in_grad_combine_kernel(
    p1_ptr, p2_ptr, s1_ptr, s2_ptr, n_splits, C,
    BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
):
    # sums the [n_splits] partials of one (b, channel block), BLOCK_S splits
    # at a time, always in the same order
    b = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    a1 = tl.zeros([BLOCK_S, BLOCK_C], dtype=tl.float32)
    a2 = tl.zeros([BLOCK_S, BLOCK_C], dtype=tl.float32)
    for s0 in range(0, n_splits, BLOCK_S):
        sp = s0 + tl.arange(0, BLOCK_S)
        mask = (sp < n_splits)[:, None] & cmask[None, :]
        off = (b * n_splits + sp[:, None]) * C + cols[None, :]
        a1 += tl.load(p1_ptr + off, mask=mask, other=0.0)
        a2 += tl.load(p2_ptr + off, mask=mask, other=0.0)
    tl.store(s1_ptr + b * C + cols, tl.sum(a1, axis=0), mask=cmask)
    tl.store(s2_ptr + b * C + cols, tl.sum(a2, axis=0), mask=cmask)


def _in_grad_input_kernel(
    x_ptr, dy_ptr, dx_ptr, mean_ptr, inv_ptr, gamma_ptr, s1_ptr, s2_ptr, S, Q, C,
    start, step, n_sel, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
):
    # dx = gamma * inv * (dy - [plane in start::step] * (s1 + xhat * s2) / n_sel)
    # over one [BLOCK_R, BLOCK_C] block
    rb = tl.program_id(0)
    b = tl.program_id(1)
    cb = tl.program_id(2)
    rows = rb * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < S)[:, None] & cmask[None, :]
    off = (b.to(tl.int64) * S + rows[:, None]) * C + cols[None, :]
    x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    dy = tl.load(dy_ptr + off, mask=mask, other=0.0).to(tl.float32)
    stat = b * C + cols
    mean = tl.load(mean_ptr + stat, mask=cmask, other=0.0)
    inv = tl.load(inv_ptr + stat, mask=cmask, other=0.0)
    gamma = tl.load(gamma_ptr + cols, mask=cmask, other=0.0)
    a = tl.load(s1_ptr + stat, mask=cmask, other=0.0) / n_sel
    c2 = tl.load(s2_ptr + stat, mask=cmask, other=0.0) / n_sel
    plane = rows // Q
    sel = (plane >= start) & ((plane - start) % step == 0)
    xhat = (x - mean[None, :]) * inv[None, :]
    corr = tl.where(sel[:, None], a[None, :] + xhat * c2[None, :], 0.0)
    dx = (gamma * inv)[None, :] * (dy - corr)
    tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=mask)


def _triton():
    global tl, _kernels
    if _kernels is None:
        import triton
        import triton.language

        tl = triton.language
        _kernels = dict(
            triton=triton,
            apply=triton.jit(_in_apply_kernel),
            grad_stats=triton.jit(_in_grad_stats_kernel),
            grad_combine=triton.jit(_in_grad_combine_kernel),
            grad_input=triton.jit(_in_grad_input_kernel),
        )
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
def _compute_type(t: torch.Tensor) -> torch.dtype:
    """float32 for float32 and narrower maps; float64 stays float64, so that
    ``torch.autograd.gradcheck`` can run the plain versions."""
    return torch.promote_types(t.dtype, torch.float32)


def in_stats_plain(
    x4: torch.Tensor, start: int = 0, step: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(b, c) float32 mean and biased variance of ``x4 [B, D, Q, C]``
    over depth planes ``start::step`` (two-pass, centered)."""
    sel = x4[:, start::step].to(_compute_type(x4))
    mean = sel.mean(dim=(1, 2))
    var = (sel - mean[:, None, None]).square().mean(dim=(1, 2))
    return mean, var


def _splits(triton, device, b: int, n_cb: int, n_rows: int, block_r: int) -> Tuple[int, int]:
    """``(n_splits, rows_per_split)`` of a reduction over ``n_rows`` rows:
    enough programs to fill the SMs, whole blocks per split."""
    n_splits = max(1, min(triton.cdiv(_PROGRAMS_PER_SM * _sm_count(device), b * n_cb),
                          triton.cdiv(n_rows, block_r)))
    rows_per_split = triton.cdiv(triton.cdiv(n_rows, n_splits), block_r) * block_r
    return triton.cdiv(n_rows, rows_per_split), rows_per_split


@dataclass(frozen=True)
class InStatsPlan:
    """How the statistics kernel covers ``x [b, d, q, c]`` over planes
    ``start::step``: ``n_rows`` selected rows (planes x ``q``) per batch
    item, channel blocks of ``cb`` channels (``n_cb`` of them), and
    ``splits`` ranges of ``rows_per_split`` rows (the last one shorter): one
    block per (split, channel block, batch item)."""

    b: int
    d: int
    q: int
    c: int
    start: int
    step: int
    n_rows: int
    cb: int
    n_cb: int
    splits: int
    rows_per_split: int

    @property
    def blocks(self) -> int:
        return self.splits * self.n_cb * self.b

    @property
    def ws_floats(self) -> int:
        """Floats of the partial means and M2s."""
        return 2 * self.b * self.n_cb * self.splits * self.cb

    def split_rows(self, split: int) -> Tuple[int, int]:
        """The selected rows ``[lo, hi)`` of one split."""
        lo = split * self.rows_per_split
        return lo, min(lo + self.rows_per_split, self.n_rows)


@functools.lru_cache(maxsize=None)
def plan_in_stats(b: int, d: int, q: int, c: int, start: int = 0, step: int = 1,
                  n_sms: int = 132) -> InStatsPlan:
    """The statistics kernel's grid for ``x [b, d, q, c]`` over planes
    ``start::step`` on a card with ``n_sms`` SMs: channel blocks of at most
    :data:`IN_STATS_CB` channels, and as many row splits as make one wave of
    :data:`IN_STATS_BLOCKS_PER_SM` blocks per SM, each at least
    :data:`IN_STATS_MIN_ROWS` rows (one split below that), at most as many
    as the last block's combine holds (:data:`IN_STATS_HOLD` per thread)."""
    n_planes = len(range(start, d, step))
    if n_planes == 0 or min(b, q, c) < 1:
        raise ValueError(f"in_stats: no row of [{b}, {d}, {q}, {c}] in planes {start}::{step}")
    n_rows = n_planes * q
    cb = min(c, IN_STATS_CB)
    n_cb = -(-c // cb)
    target = IN_STATS_BLOCKS_PER_SM * n_sms // (b * n_cb)
    hold = IN_STATS_HOLD * (IN_STATS_THREADS // (1 << (cb - 1).bit_length()))
    splits = max(1, min(target, n_rows // IN_STATS_MIN_ROWS, hold))
    rows_per_split = -(-n_rows // splits)
    return InStatsPlan(b, d, q, c, start, step, n_rows, cb, n_cb, -(-n_rows // rows_per_split),
                       rows_per_split)


def _stats_kernel():
    global _stats_fn
    if _stats_fn is None:
        fn = _build.load().in_stats_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int,                     # x, dtype code
            ctypes.POINTER(ctypes.c_int),                      # the plan's 11 integers
            ctypes.c_void_p, ctypes.c_void_p,                  # partials, counters
            ctypes.c_void_p,                                   # out [2, B, C]
            ctypes.c_void_p, ctypes.c_int,                     # stream, device
        ]
        fn.restype = ctypes.c_int
        _stats_fn = fn
    return _stats_fn


@functools.lru_cache(maxsize=None)
def _plan_ints(plan: InStatsPlan):
    """The plan as the C entry point reads it, built once per plan."""
    return (ctypes.c_int * 11)(plan.b, plan.d, plan.q, plan.c, plan.start, plan.step,
                               plan.n_rows, plan.cb, plan.n_cb, plan.splits, plan.rows_per_split)


def _stats_workspace(device: torch.device, stream: int, n_floats: int, n_counters: int):
    """The (partials, counters) buffer of ``stream`` on ``device``, grown to
    at least the sizes asked for (see ``_stats_ws``)."""
    key = (device.index, stream)
    ws = _stats_ws.get(key)
    if ws is None or ws[0].numel() < n_floats or ws[1].numel() < n_counters:
        n_floats = max(n_floats, ws[0].numel() if ws else 0)
        n_counters = max(n_counters, ws[1].numel() if ws else 0)
        ws = _stats_ws[key] = (torch.empty(n_floats, dtype=torch.float32, device=device),
                               torch.zeros(n_counters, dtype=torch.int32, device=device))
    return ws


def _in_stats_cuda(x4, start, step):
    _check_map(x4, "in_stats")
    b, d, q, c = x4.shape
    dev = x4.device
    plan = plan_in_stats(b, d, q, c, start, step, _sm_count(dev))
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part, counters = _stats_workspace(dev, stream, plan.ws_floats, b * plan.n_cb)
    # the call's one allocation: both results
    out = torch.empty((2, b, c), dtype=torch.float32, device=dev)
    err = _stats_kernel()(x4.data_ptr(), _DTYPES[x4.dtype], _plan_ints(plan), part.data_ptr(),
                          counters.data_ptr(), out.data_ptr(), stream, dev.index)
    _build.check(err, "in_stats_launch")
    LAUNCHES["in_stats"] += 1
    return out[0], out[1]


def in_stats(
    x4: torch.Tensor, start: int = 0, step: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatching wrapper of :func:`in_stats_plain` (CPU) and the CUDA
    statistics kernel of ``csrc/instance_norm_stats.cu`` (CUDA)."""
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
    y = (x4.to(_compute_type(x4)) - mean[:, None, None]) * scale[:, None, None] + beta
    return y.to(x4.dtype)


def _in_apply_cuda(x4, mean, var, gamma, beta, eps):
    _check_map(x4, "in_apply")
    b, d, q, c = x4.shape
    _check_stat(mean, (b, c), x4, "in_apply mean")
    _check_stat(var, (b, c), x4, "in_apply var")
    _check_stat(gamma, (c,), x4, "in_apply gamma")
    _check_stat(beta, (c,), x4, "in_apply beta")
    k = _triton()
    s = d * q
    block_r, block_c = _blocks(c)
    y = torch.empty_like(x4)
    grid = (k["triton"].cdiv(s, block_r), b, k["triton"].cdiv(c, block_c))
    with torch.cuda.device(x4.device):
        k["apply"][grid](
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


# ------------------------------------------------------- gradient sums
def in_grad_stats_plain(
    x4: torch.Tensor, dy4: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s1 = sum(dy)`` and ``s2 = sum(dy * (x - mean) * inv)`` per (b, c)
    over every voxel of ``[B, D, Q, C]``, float32."""
    t = _compute_type(x4)
    dy = dy4.to(t)
    xhat = (x4.to(t) - mean[:, None, None]) * inv[:, None, None]
    return dy.sum(dim=(1, 2)), (dy * xhat).sum(dim=(1, 2))


def _check_grad_map(x4, dy4, name):
    _check_map(x4, name)
    _check_map(dy4, name)
    if dy4.shape != x4.shape or dy4.device != x4.device:
        raise ValueError(f"{name}: dy {tuple(dy4.shape)} on {dy4.device} does not match "
                         f"x {tuple(x4.shape)} on {x4.device}")


def _in_grad_stats_cuda(x4, dy4, mean, inv):
    _check_grad_map(x4, dy4, "in_grad_stats")
    b, d, q, c = x4.shape
    _check_stat(mean, (b, c), x4, "in_grad_stats mean")
    _check_stat(inv, (b, c), x4, "in_grad_stats inv")
    k = _triton()
    triton = k["triton"]
    s = d * q
    block_r, block_c = _blocks(c)
    n_cb = triton.cdiv(c, block_c)
    n_splits, rows_per_split = _splits(triton, x4.device, b, n_cb, s, block_r)
    part = torch.empty((2, b, n_splits, c), dtype=torch.float32, device=x4.device)
    s1, s2 = torch.empty((2, b, c), dtype=torch.float32, device=x4.device)
    with torch.cuda.device(x4.device):
        k["grad_stats"][(n_splits, b, n_cb)](
            x4, dy4, mean, inv, part[0], part[1], s, c, rows_per_split,
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8,
        )
        k["grad_combine"][(b, n_cb)](
            part[0], part[1], s1, s2, n_splits, c,
            BLOCK_S=_COMBINE_SPLITS, BLOCK_C=block_c, num_warps=4,
        )
    LAUNCHES["in_grad_stats"] += 1
    return s1, s2


def in_grad_stats(
    x4: torch.Tensor, dy4: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatching wrapper of :func:`in_grad_stats_plain` (CPU) and the Triton
    gradient-sum kernel (CUDA). ``mean``/``inv [B, C]`` float32."""
    if x4.device.type == "cpu":
        return in_grad_stats_plain(x4, dy4, mean, inv)
    if x4.device.type == "cuda":
        return _in_grad_stats_cuda(x4, dy4, mean, inv)
    raise NotImplementedError(f"in_grad_stats has no kernel for {x4.device}")


# ------------------------------------------------------- input gradient
def in_grad_input_plain(
    x4: torch.Tensor, dy4: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
    gamma: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor, start: int = 0, step: int = 1,
) -> torch.Tensor:
    """``dx = gamma * inv * (dy - [plane in start::step] * (s1 + xhat * s2) / n)``
    with ``n`` the voxels of the selected planes; float32, stored in x's
    type."""
    t = _compute_type(x4)
    b, d, q, c = x4.shape
    n_sel = len(range(start, d, step)) * q
    xhat = (x4.to(t) - mean[:, None, None]) * inv[:, None, None]
    sel = torch.zeros(d, dtype=t, device=x4.device)
    sel[start::step] = 1.0
    corr = (s1[:, None, None] + xhat * s2[:, None, None]) / n_sel
    dx = (gamma * inv)[:, None, None] * (dy4.to(t) - sel[:, None, None] * corr)
    return dx.to(x4.dtype)


def _in_grad_input_cuda(x4, dy4, mean, inv, gamma, s1, s2, start, step):
    _check_grad_map(x4, dy4, "in_grad_input")
    b, d, q, c = x4.shape
    for name, t, shape in (("mean", mean, (b, c)), ("inv", inv, (b, c)), ("gamma", gamma, (c,)),
                           ("s1", s1, (b, c)), ("s2", s2, (b, c))):
        _check_stat(t, shape, x4, f"in_grad_input {name}")
    n_sel = len(range(start, d, step)) * q
    if n_sel == 0:
        raise ValueError(f"in_grad_input: no plane selected by {start}::{step} of {d}")
    k = _triton()
    s = d * q
    block_r, block_c = _blocks(c)
    dx = torch.empty_like(x4)
    grid = (k["triton"].cdiv(s, block_r), b, k["triton"].cdiv(c, block_c))
    with torch.cuda.device(x4.device):
        k["grad_input"][grid](
            x4, dy4, dx, mean, inv, gamma, s1, s2, s, q, c, start, step, float(n_sel),
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8,
        )
    LAUNCHES["in_grad_input"] += 1
    return dx


def in_grad_input(
    x4: torch.Tensor, dy4: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
    gamma: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor, start: int = 0, step: int = 1,
) -> torch.Tensor:
    """Dispatching wrapper of :func:`in_grad_input_plain` (CPU) and the
    Triton input-gradient kernel (CUDA). Statistics and sums float32."""
    if x4.device.type == "cpu":
        return in_grad_input_plain(x4, dy4, mean, inv, gamma, s1, s2, start, step)
    if x4.device.type == "cuda":
        return _in_grad_input_cuda(x4, dy4, mean, inv, gamma, s1, s2, start, step)
    raise NotImplementedError(f"in_grad_input has no kernel for {x4.device}")


# ------------------------------------------------------------ composite
class InstanceNormFunction(torch.autograd.Function):
    """Instance norm of ``x4 [B, D, Q, C]`` through the four wrappers: the
    statistics over planes ``start::step``, the affine apply, and a backward
    of one gradient-sum pass and one input-gradient pass.

    With a process ``group``, ``x4`` is a D-slab of a map sharded over the
    group's ranks and the norm takes the global map's exact statistics (the
    JAX package's spatial norm does so whatever ``NNDET_IN_STATS`` says;
    pass ``start=0, step=1``). Forward: #1's local mean and variance are
    merged over the group by Chan's formula (the global mean from the
    summed ``count * mean``, then ``M2 = sum(count * var + count * (mean -
    global mean)^2)``) before #2 applies them. Backward: #3's local sums
    give the local parameter gradients, then are summed over the group for
    #4, which divides by the local voxel count: the summed sums enter it
    divided by the group's size, so that it divides by the global count.
    On CPU tensors the plain versions run with the same all-reduces.

    It saves its input (in x's type), ``mean`` and ``inv``, never its
    output: ``ConvNormAct`` applies ``relu_`` to the output in place."""

    @staticmethod
    def forward(ctx, x4, gamma, beta, eps: float, start: int, step: int, group=None):
        mean, var = in_stats(x4, start, step)
        if group is not None:
            count = torch.full_like(mean, float(x4.shape[1] * x4.shape[2]))
            sums = torch.stack([count * mean, count])
            dist.all_reduce(sums, group=group)
            g_mean = sums[0] / sums[1]
            m2 = count * var + count * (mean - g_mean).square()
            dist.all_reduce(m2, group=group)
            mean, var = g_mean, m2 / sums[1]
        y = in_apply(x4, mean, var, gamma, beta, eps)
        ctx.save_for_backward(x4, mean, torch.rsqrt(var + eps), gamma)
        ctx.planes, ctx.group = (start, step), group
        return y

    @staticmethod
    def backward(ctx, dy):
        x4, mean, inv, gamma = ctx.saved_tensors
        dy = dy.contiguous()
        s1, s2 = in_grad_stats(x4, dy, mean, inv)
        d_gamma, d_beta = s2.sum(dim=0), s1.sum(dim=0)
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.group is not None:
                sums = torch.stack([s1, s2])
                dist.all_reduce(sums, group=ctx.group)
                s1, s2 = sums / dist.get_world_size(ctx.group)
            dx = in_grad_input(x4, dy, mean, inv, gamma, s1, s2, *ctx.planes)
        return dx, d_gamma, d_beta, None, None, None, None


def plane_schedule(depth: int, plane_stride: Optional[int]) -> Tuple[int, int]:
    """``(start, step)`` of the depth planes the statistics read: every
    ``plane_stride``-th plane from ``plane_stride // 2`` (the JAX package's
    ``plane_sub`` estimator), or all planes when there is no stride or the
    depth is below ``2 * plane_stride``."""
    if plane_stride is None or depth < 2 * plane_stride:
        return 0, 1
    return plane_stride // 2, plane_stride


def _as_map(x: torch.Tensor) -> torch.Tensor:
    b, d, c = x.shape[0], x.shape[1], x.shape[-1]
    return x.view(b, d, math.prod(x.shape[2:-1]), c)


def instance_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-5,
    plane_stride: Optional[int] = None,
) -> torch.Tensor:
    """Instance norm of a channel-last map ``x [B, D, *spatial, C]`` with
    ``gamma``/``beta [C]``; statistics over the planes of
    :func:`plane_schedule`. Output in x's type; differentiable through
    :class:`InstanceNormFunction`."""
    start, step = plane_schedule(x.shape[1], plane_stride)
    y = InstanceNormFunction.apply(_as_map(x), gamma, beta, eps, start, step, None)
    return y.view(x.shape)


def spatial_instance_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-5,
    group=None,
) -> torch.Tensor:
    """:func:`instance_norm` of a channel-last map ``x [B, D, *spatial, C]``
    sharded along D over ``group`` (the world when None): exact statistics
    of the global map (:class:`InstanceNormFunction` with a group)."""
    group = group if group is not None else dist.group.WORLD
    y = InstanceNormFunction.apply(_as_map(x), gamma, beta, eps, 0, 1, group)
    return y.view(x.shape)


def instance_norm_plain(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-5,
    plane_stride: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`instance_norm` (PyTorch's autograd
    differentiates it)."""
    x4 = _as_map(x)
    start, step = plane_schedule(x.shape[1], plane_stride)
    mean, var = in_stats_plain(x4, start, step)
    return in_apply_plain(x4, mean, var, gamma, beta, eps).view(x.shape)
