"""Plain train steps of the Retina U-Net: float32 forward and backward of
:class:`~.model.Net`, the losses of :mod:`.detect`, then nnDetection's
optimizer as its trainer states it (``nndet/ptmodule/base_module.py``):
the gradient clipped to a global norm (``g * max_norm / norm`` when the norm
reaches it), weight decay on the conv kernels only, SGD with Nesterov
momentum, the learning rate of warm-up then poly decay (:mod:`.lr`).

The steps follow the program's own draws: each step takes the batch the
program trained on, after its augmentation and target preparation, and the
state of the program's random generator as its loss sampler found it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .detect import train_step_loss
from .lr import swa_schedule
from .model import Net

LOSS_KEYS = ("cls", "reg", "seg_ce", "seg_dice")


def schedule(tcfg: dict):
    return swa_schedule(
        initial_lr=tcfg["initial_lr"], warm_iterations=tcfg["warm_iterations"],
        warm_lr=tcfg["warm_lr"], poly_gamma=tcfg["poly_gamma"],
        train_iterations=tcfg["max_epochs"] * tcfg["num_train_batches_per_epoch"],
        swa_cycle_iterations=max(1, tcfg["num_train_batches_per_epoch"]))


def run_steps(cfg: dict, tcfg: dict, params: Dict[str, torch.Tensor], decayed: Sequence[str],
              batches: List[Dict[str, torch.Tensor]], generator_states: List[torch.Tensor],
              anchor_grid: torch.Tensor, anchors_per_level: Sequence[int],
              quant=None, drop_half: bool = False,
              momentum_buffers: Optional[Dict[str, torch.Tensor]] = None,
              start_step: int = 0) -> dict:
    """Train steps from ``params`` (float32, copied) on ``batches``; step
    ``i``'s sampler draws from a generator in ``generator_states[i]``. The
    optimizer starts from ``momentum_buffers`` (none: a fresh optimizer)
    with ``start_step`` updates already applied (the schedule's count).
    Returns each step's ``losses`` (floats), the first step's gradient as
    SGD takes it, clipped and decayed (``first_grad``, per parameter), and
    the parameters after the last step (``params``). ``quant`` runs the
    forward in the control's precision; ``drop_half`` trains on the first
    half of each batch."""
    p = {k: v.detach().float().clone().requires_grad_(True) for k, v in params.items()}
    buf = {k: v.detach().float().clone() for k, v in (momentum_buffers or {}).items()}
    lr_of = schedule(tcfg)
    momentum, nesterov, wd = tcfg["sgd_momentum"], tcfg["sgd_nesterov"], tcfg["weight_decay"]
    clip = tcfg["grad_clip_norm"]
    out = {"losses": [], "first_grad": None}
    device = anchor_grid.device
    for step, (batch, state) in enumerate(zip(batches, generator_states)):
        if drop_half:
            half = batch["images"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        net = Net(cfg, p, quant=quant)
        gen = torch.Generator(device=device)
        gen.set_state(state)
        fmaps = checkpoint(net.encoder, batch["images"].float().movedim(-1, 1),
                           use_reentrant=False)
        preds = net.heads(checkpoint(net.decoder, fmaps, use_reentrant=False))
        losses = train_step_loss(cfg, preds, anchor_grid, anchors_per_level, batch, gen)
        total = sum(losses[k] for k in LOSS_KEYS)
        grads = torch.autograd.grad(total, list(p.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p[k]))
                 for k, g in zip(p, grads)}
        norm = float(torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads.values()])))
        out["losses"].append({k: float(v.detach()) for k, v in losses.items()}
                             | {"total": float(total.detach())})
        if not math.isfinite(norm):
            raise FloatingPointError(f"reference step {step}: gradient norm {norm}")
        lr = lr_of(start_step + step)
        first = {}
        with torch.no_grad():
            for k, g in grads.items():
                if clip and not norm < clip:
                    g = g / norm * clip
                d = g + wd * p[k] if k in decayed else g
                if step == 0:
                    first[k] = d.clone()
                buf[k] = d.clone() if k not in buf else buf[k].mul_(momentum).add_(d)
                upd = d + momentum * buf[k] if nesterov else buf[k]
                p[k].sub_(lr * upd)
        if step == 0:
            out["first_grad"] = first
    out["params"] = {k: v.detach() for k, v in p.items()}
    return out
