"""Fused 3x3x3 convolution with instance-norm statistics: the counterpart of
``nndetection_tpu/ops/pallas_conv.py``.

* :func:`supported` is the JAX package's predicate for the fused path
  (``pallas_conv.py:220-227`` with ``_pick_t`` ``:55-65``): a 3x3x3 kernel,
  stride 1, 3-D, and an ``[H, W, Ci]`` bf16 plane within the TPU kernel's
  2 MiB block budget. The card has no such limit, but which layers are fused
  is part of the model's semantics (a fused layer uses exact statistics, an
  unfused one ``plane_sub:8``), so the port keeps the same rule.
* :func:`conv3d_in_stats` replaces ``_conv3d_in_stats_fwd_impl``
  (``pallas_conv.py:123``, its ``_kernel`` ``:68``): ``y = conv3d(x, w)``,
  SAME, NDHWC, bf16 in and out with float32 accumulation, and the per-(b, c)
  mean and biased variance of the rounded ``y`` over all voxels. A CUDA
  tensor launches the CUDA C++ kernel of ``csrc/conv3d_in_stats.cu`` on the
  route :func:`plan_conv` picks (a halo brick in shared memory, split-K, or
  the im2col gather); a CPU tensor runs :func:`conv3d_in_stats_plain`.
* :class:`ConvInstanceNormFunction` is conv + instance norm as one
  ``torch.autograd.Function``: the forward is the fused kernel and the
  affine apply (``in_apply``) with the conv's statistics; the backward folds
  the cotangents through the normalisation and through ``mean``/``var``
  into the instance-norm backward over all planes (``in_grad_stats`` +
  ``in_grad_input``), rounds it to bf16 as ``_bwd`` does
  (``pallas_conv.py:213``), and takes the convolution's VJP in bf16. As in
  the JAX package, where that VJP is XLA's, only the forward is a
  hand-written kernel: on the card the VJP is cuDNN's
  (``aten.convolution_backward``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nndetection_tpu_torch.ops import LAUNCHES, _build
from nndetection_tpu_torch.ops.instance_norm import (
    in_apply,
    in_grad_input,
    in_grad_stats,
)

# the TPU kernel's VMEM budget for its main input block (pallas_conv.py:52)
_BLOCK_BYTES = 2 * 1024 * 1024

_launch_fn = None
_n_sms = {}

# the kernel's tiling (csrc/conv3d_in_stats.cu): K step, Co padding of the
# packed weights, a brick's run of w, the halo brick's bf16 voxel pitch
BK = 32
CO_ALIGN = 64
BRICK_W = 16
PITCH = 40
# the brick's pipelines, (taps per K step, weight buffers in the ring), and
# the one each output-channel tile takes (the faster on the H100 at the LUNA
# plan's stages: PERF.md)
BRICK_PIPELINES = ((1, 4), (3, 2))
BRICK_PIPELINE = {32: (1, 4), 64: (3, 2)}
# shared memory one block may use on the H100, and what the kernel keeps
# of it for its static arrays
SMEM_MAX = 232_448
SMEM_STATIC = 2048
# the route numbers of the C entry point
ROUTES = {"im2col": 0, "split_k": 1, "brick": 2}
# brick shapes (Td, Th) per output-channel tile, least halo first: Td*Th*16
# voxels, 256 for 32-channel tiles and 128 for 64-channel ones
BRICKS = {32: ((4, 4), (2, 8), (8, 2), (1, 16), (16, 1)),
          64: ((2, 4), (4, 2), (1, 8), (8, 1))}
# split-K keeps at least this many K steps per split, and aims at this many
# blocks per SM
MIN_SPLIT_STEPS = 8
SPLIT_BLOCKS_PER_SM = 2


@dataclass(frozen=True)
class ConvPlan:
    """How the kernel tiles one conv: ``route`` ("brick", "split_k" or
    "im2col"), ``bm`` voxels x ``bn`` output channels per block, the grid
    ``n_tiles x m_tiles x batch`` (times ``splits`` on the split-K route), the
    brick ``td x th x 16`` and its pipeline (``taps`` per K step, a ring of
    ``stages`` weight buffers; 0 off the brick route), ``splits`` K ranges of
    ``k_steps`` steps of :data:`BK` (split ``s`` takes steps
    ``[s * k_steps, min((s + 1) * k_steps, n_k))``), the brick's dynamic
    shared memory and the split-K workspace in bytes."""

    route: str
    x_shape: Tuple[int, int, int, int, int]
    co: int
    bm: int
    bn: int
    n_tiles: int
    m_tiles: int
    td: int = 0
    th: int = 0
    taps: int = 0
    stages: int = 0
    splits: int = 1
    k_steps: int = 0
    smem_bytes: int = 0
    ws_bytes: int = 0

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.m_tiles * self.x_shape[0] * self.splits


def k_pad(ci: int) -> int:
    return -(-27 * ci // BK) * BK


def brick_smem_bytes(ci: int, bm: int, bn: int, td: int, th: int, taps: int,
                     stages: int) -> int:
    """The brick route's dynamic shared memory: one halo brick buffer for
    Ci = 32, two (double-buffered over 32-channel chunks) above, the ring of
    ``stages`` weight buffers of ``taps`` taps; at least the f32 output tile
    that overlays them."""
    nbuf = 2 if ci > 32 else 1
    pipe = (nbuf * (td + 2) * (th + 2) * (BRICK_W + 2) * PITCH * 2
            + stages * taps * BK * (bn + 8) * 2)
    return max(pipe, bm * (bn + 4) * 4)


def plan_conv(x_shape: Sequence[int], co: int, n_sms: int = 132, route: Optional[str] = None,
              brick_pipeline: Optional[Tuple[int, int]] = None) -> ConvPlan:
    """The kernel's route for ``x [B, D, H, W, Ci] -> Co`` on a card with
    ``n_sms`` SMs:

    * "brick" when ``Ci % 32 == 0``, ``W % 16 == 0``, a brick divides the
      volume and the bricks give at least ``n_sms`` blocks;
    * "split_k" otherwise when ``Ci % 8 == 0`` and the im2col grid is under
      ``n_sms`` blocks: ``splits`` so that the grid reaches
      :data:`SPLIT_BLOCKS_PER_SM` blocks per SM, each split at least
      :data:`MIN_SPLIT_STEPS` K steps;
    * "im2col", the gather of every K step from x, for the rest (the stem).

    ``route`` forces one (to compare the routes on the card), where the
    shape allows it; a ValueError where it does not. ``brick_pipeline``
    forces one of :data:`BRICK_PIPELINES` on the brick route.
    """
    b, d, h, w, ci = (int(v) for v in x_shape)
    shape = (b, d, h, w, ci)
    bn = 64 if co % 64 == 0 else 32
    bm = 8192 // bn
    n_tiles = -(-co // bn)
    n_k = k_pad(ci) // BK
    taps, stages = brick_pipeline or BRICK_PIPELINE[bn]
    if (taps, stages) not in BRICK_PIPELINES:
        raise ValueError(f"no brick pipeline {(taps, stages)}: one of {BRICK_PIPELINES}")
    if route in (None, "brick") and ci % 32 == 0 and w % BRICK_W == 0:
        for td, th in BRICKS[bn]:
            smem = brick_smem_bytes(ci, bm, bn, td, th, taps, stages)
            if d % td or h % th or smem > SMEM_MAX - SMEM_STATIC:
                continue
            m_tiles = (d // td) * (h // th) * (w // BRICK_W)
            if route or n_tiles * m_tiles * b >= n_sms:
                return ConvPlan("brick", shape, co, bm, bn, n_tiles, m_tiles, td=td, th=th,
                                taps=taps, stages=stages, k_steps=n_k, smem_bytes=smem)
            break
    m_tiles = -(-(d * h * w) // bm)
    grid = n_tiles * m_tiles * b
    if route in (None, "split_k") and ci % 8 == 0 and grid < n_sms:
        splits = min(-(-SPLIT_BLOCKS_PER_SM * n_sms // grid), n_k // MIN_SPLIT_STEPS)
        while splits > 1:  # equal splits, the last one shorter but not too short
            k_steps = -(-n_k // splits)
            if n_k - (-(-n_k // k_steps) - 1) * k_steps >= MIN_SPLIT_STEPS:
                break
            splits -= 1
        if splits > 1:
            splits = -(-n_k // k_steps)  # no empty split
            ws = splits * b * m_tiles * bm * n_tiles * bn * 4
            return ConvPlan("split_k", shape, co, bm, bn, n_tiles, m_tiles, splits=splits,
                            k_steps=k_steps, ws_bytes=ws)
    if route in (None, "im2col"):
        return ConvPlan("im2col", shape, co, bm, bn, n_tiles, m_tiles, k_steps=n_k)
    raise ValueError(f"no {route} plan for {shape} -> {co} at {n_sms} SMs")


def _pick_t(d: int, h: int, w: int, ci: int) -> int:
    """Largest divisor of ``d`` whose (T, H, W, Ci) bf16 block fits the
    budget; 0 when even T = 1 does not fit (``pallas_conv.py:55-65``)."""
    plane = h * w * ci * 2
    best = 0
    for t in range(1, d + 1):
        if d % t == 0 and t * plane <= _BLOCK_BYTES:
            best = t
    return best


def supported(x_shape: Sequence[int], kernel_size: Sequence[int], strides: Sequence[int],
              dim: int) -> bool:
    """Whether a conv on ``x_shape = (B, D, H, W, Ci)`` takes the fused path:
    the JAX package's rule, budget included."""
    if dim != 3 or tuple(kernel_size) != (3, 3, 3) or tuple(strides) != (1, 1, 1):
        return False
    _, d, h, w, ci = x_shape
    return _pick_t(d, h, w, ci) > 0


# ------------------------------------------------------------------ forward
def conv3d_in_stats_plain(
    x: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``F.conv3d`` on the bf16-rounded
    ``x [B, D, H, W, Ci]`` and ``w [3, 3, 3, Ci, Co]``, one rounding to bf16,
    then two-pass float32 statistics of the rounded ``y``.

    The convolution runs in float64, a sum more exact than the kernel's
    float32 one: on the card cuDNN picks its float32 algorithm itself, and
    its transform-based ones were up to 4 bf16 ulps off at Ci = 256, which
    would make the reference the less exact side.

    Returns ``y [B, D, H, W, Co]`` bf16 and ``mean``/``var [B, Co]``
    float32."""
    xf = x.to(torch.bfloat16).double().permute(0, 4, 1, 2, 3)
    wf = w.to(torch.bfloat16).double().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf, padding=1).to(torch.bfloat16).permute(0, 2, 3, 4, 1)
    yf = y.float()
    mean = yf.mean(dim=(1, 2, 3))
    var = (yf - mean[:, None, None, None]).square().mean(dim=(1, 2, 3))
    return y.contiguous(), mean, var


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load().conv3d_in_stats_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,                  # x, packed w
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, D, H, W
            ctypes.c_int, ctypes.c_int,                        # Ci, Co
            ctypes.c_int, ctypes.c_int,                        # K_pad, Co_pad
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # route, bm, td, th
            ctypes.c_int, ctypes.c_int,                        # brick taps, stages
            ctypes.c_int, ctypes.c_int, ctypes.c_int,          # splits, k_steps, smem bytes
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # y, partials
            ctypes.c_void_p,                                   # split-K workspace
            ctypes.c_void_p, ctypes.c_void_p,                  # mean, var
            ctypes.c_void_p,                                   # stream
        ]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def sm_count(device: torch.device) -> int:
    """The card's number of SMs (cached per device)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _n_sms:
        _n_sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _n_sms[idx]


def pack_weight(w: torch.Tensor, k_align: int, co_align: int) -> torch.Tensor:
    """``w [3, 3, 3, Ci, Co]`` -> the kernel's bf16 ``[K_pad, Co_pad]``: row
    ``k = tap * Ci + ci`` with ``tap = (dz * 3 + dy) * 3 + dx``, zeros
    beyond ``K = 27 * Ci`` and beyond ``Co``."""
    ci, co = w.shape[3], w.shape[4]
    k = 27 * ci
    k_pad = -(-k // k_align) * k_align
    co_pad = -(-co // co_align) * co_align
    out = torch.zeros((k_pad, co_pad), dtype=torch.bfloat16, device=w.device)
    out[:k, :co].view(3, 3, 3, ci, co).copy_(w)  # one copy from any strides of w
    return out


def _conv3d_in_stats_cuda(x, w, plan: Optional[ConvPlan] = None):
    if x.dim() != 5 or w.shape[:3] != (3, 3, 3) or w.dim() != 5 or w.shape[3] != x.shape[4]:
        raise ValueError(f"conv3d_in_stats takes x [B, D, H, W, Ci] and w [3, 3, 3, Ci, Co], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv3d_in_stats takes bfloat16 x on the card, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3d_in_stats takes a contiguous channel-last x")
    if w.device != x.device:
        raise ValueError("x and w on different devices")
    b, d, h, wd, ci = x.shape
    co = w.shape[4]
    if co % 2:
        raise ValueError(f"conv3d_in_stats takes an even number of output channels, got {co}")
    if plan is None:
        plan = plan_conv(x.shape, co, sm_count(x.device))
    elif plan.x_shape != tuple(x.shape) or plan.co != co:
        raise ValueError(f"a plan for {plan.x_shape} -> {plan.co}, "
                         f"called on {tuple(x.shape)} -> {co}")
    fn = _kernel()
    wpk = pack_weight(w, BK, CO_ALIGN)
    y = torch.empty((b, d, h, wd, co), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((2, b, plan.m_tiles, co), dtype=torch.float32, device=x.device)
    mean, var = torch.empty((2, b, co), dtype=torch.float32, device=x.device)
    ws = (torch.empty(plan.ws_bytes // 4, dtype=torch.float32, device=x.device)
          if plan.ws_bytes else None)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wpk.data_ptr(), b, d, h, wd, ci, co, wpk.shape[0], wpk.shape[1],
                 ROUTES[plan.route], plan.bm, plan.td, plan.th, plan.taps, plan.stages,
                 plan.splits, plan.k_steps,
                 plan.smem_bytes, y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                 None if ws is None else ws.data_ptr(), mean.data_ptr(), var.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_in_stats_launch")
    LAUNCHES["conv3d_in_stats"] += 1
    return y, mean, var


def conv3d_in_stats(
    x: torch.Tensor, w: torch.Tensor, plan: Optional[ConvPlan] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``y = conv3d(x, w)`` (bf16, SAME, stride 1) of ``x [B, D, H, W, Ci]``
    and ``w [3, 3, 3, Ci, Co]``, plus the per-(b, c) float32 mean and
    variance of ``y``: the CUDA kernel for a CUDA ``x`` (bf16, contiguous) on
    the route of ``plan`` (default :func:`plan_conv` for the card),
    :func:`conv3d_in_stats_plain` for a CPU one. No gradient: see
    :class:`ConvInstanceNormFunction`."""
    if x.device.type == "cpu":
        return conv3d_in_stats_plain(x, w)
    if x.device.type == "cuda":
        return _conv3d_in_stats_cuda(x, w, plan)
    raise NotImplementedError(f"conv3d_in_stats has no kernel for {x.device}")


# ----------------------------------------------------------------- backward
def conv3d_vjp(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, need_dx: bool,
               need_dw: bool):
    """VJP of the bf16 SAME 3x3x3 convolution (``pallas_conv.py:212-213``):
    ``dy``, ``x`` ``[B, C, D, H, W]`` and ``weight [Co, Ci, 3, 3, 3]``, all
    bf16; ``(dx, dw)`` rounded to bf16, as XLA's bf16 conv VJP gives them.
    cuDNN on the card; on the CPU the same products summed in float32 and
    rounded once."""
    mask = [need_dx, need_dw, False]
    if dy.device.type == "cpu":
        dy, x, weight = dy.float(), x.float(), weight.float()
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy, x, weight, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, mask)
    return (dx.to(torch.bfloat16) if need_dx else None,
            dw.to(torch.bfloat16) if need_dw else None)


class ConvInstanceNormFunction(torch.autograd.Function):
    """Conv (3x3x3, stride 1, SAME, bf16) + instance norm with the conv's
    exact statistics, on ``x [B, D, H, W, Ci]`` channel-last; the output is
    the ``[B, D, H*W, Co]`` map (a view of it made inside the Function could
    not be modified in place).

    Forward: :func:`conv3d_in_stats`, then ``in_apply`` with its statistics
    on ``y`` upcast to ``out_dtype`` (a float32 model normalises in float32
    the bf16 ``y``, as the JAX package's ``InstanceNorm(x, stats=...)``
    promotes). Backward: with ``x̂ = (y - mean) * inv`` and all planes,
    ``dy_conv = γ·inv·(dy − (s1 + x̂·s2)/N)`` (``in_grad_stats`` +
    ``in_grad_input``) rounded to bf16, then :func:`conv3d_vjp`;
    ``dγ = Σ_b s2``, ``dβ = Σ_b s1``. ``dx`` comes back in x's type and
    ``dw`` in the weight's.

    It saves the conv's input (bf16), the weight, ``y`` and the statistics,
    never its output: ``ConvNormAct`` applies ``relu_`` to it in place."""

    @staticmethod
    def forward(ctx, x, weight, gamma, beta, eps: float, out_dtype: torch.dtype):
        xb = x.to(torch.bfloat16).contiguous()
        w = weight.permute(2, 3, 4, 1, 0)  # [Co, Ci, 3, 3, 3] -> [3, 3, 3, Ci, Co]
        y, mean, var = conv3d_in_stats(xb, w)
        b, d, h, wd, co = y.shape
        y4 = y.view(b, d, h * wd, co)
        out = in_apply(y4.to(out_dtype), mean, var, gamma, beta, eps)
        ctx.save_for_backward(xb, weight, y4, mean, torch.rsqrt(var + eps), gamma)
        ctx.x_dtype = x.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        xb, weight, y4, mean, inv, gamma = ctx.saved_tensors
        dy4 = dout.contiguous()
        s1, s2 = in_grad_stats(y4, dy4, mean, inv)
        need_dx, need_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dx = dw = None
        if need_dx or need_dw:
            # the conv's cotangent, in y's type (bf16): _bwd's rounding
            dyc = in_grad_input(y4, dy4, mean, inv, gamma, s1, s2, 0, 1)
            b, d, h, wd, ci = xb.shape
            dyc = dyc.view(b, d, h, wd, -1).permute(0, 4, 1, 2, 3)
            dx, dw = conv3d_vjp(dyc, xb.permute(0, 4, 1, 2, 3), weight.to(torch.bfloat16),
                                need_dx, need_dw)
            dx = dx.permute(0, 2, 3, 4, 1).to(ctx.x_dtype) if need_dx else None
            dw = dw.to(weight.dtype) if need_dw else None
        return dx, dw, s2.sum(dim=0), s1.sum(dim=0), None, None


def conv_instance_norm(x: torch.Tensor, weight: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-5,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Conv + instance norm of ``x [B, D, H, W, Ci]`` with ``weight [Co, Ci,
    3, 3, 3]`` (the port's conv parameter) through
    :class:`ConvInstanceNormFunction`; output ``[B, D, H, W, Co]`` in
    ``out_dtype``."""
    b, d, h, w = x.shape[:4]
    out = ConvInstanceNormFunction.apply(x, weight, gamma, beta, eps, out_dtype)
    return out.view(b, d, h, w, -1)
