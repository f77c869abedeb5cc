"""Memory estimates for the planner (counterpart of
:mod:`nndetection_tpu.planning.estimator`).

* :func:`analytic_estimate`: closed-form activation accounting of the
  RetinaUNet topology (forward and backward activations, parameters,
  optimizer state, matching workspace), copied. It drives the planner's
  shrink loop.
* :func:`probe_train_step_estimate`: runs the candidate's real train step on
  the card and reads the CUDA allocator, as nnDetection's planner probed its
  GPU with real train steps. The JAX package compiles the step for its
  accelerator and reads XLA's memory analysis instead, because that
  accelerator has no allocator to read. The two numbers differ by design:
  the probe measures what is live during a step above what was allocated
  before the trainer existed; XLA reports arguments + outputs + temporaries
  less the aliased bytes.

The budget is the caller's: the planner takes 0.85 x the card's memory.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from nndetection_tpu_torch.models.decoder import ufpn_out_channels
from nndetection_tpu_torch.models.encoder import encoder_channels, encoder_strides


@dataclass
class MemoryEstimate:
    """``total_bytes`` of one train step. ``out_of_memory``: the probed step
    did not fit the card at all; ``total_bytes`` is then what it had reached
    when the allocation failed, and the estimate fits no budget."""

    total_bytes: int
    breakdown: Dict[str, int]
    out_of_memory: bool = False

    def fits(self, budget: int) -> bool:
        return not self.out_of_memory and self.total_bytes <= budget


def analytic_estimate(
    patch_size: Sequence[int],
    batch_size: int,
    in_channels: int,
    conv_kernels,
    strides,
    decoder_levels,
    start_channels: int = 32,
    max_channels: int = 320,
    fpn_channels: int = 128,
    head_channels: int = 128,
    anchors_per_loc: int = 27,
    num_classes: int = 1,
    bytes_per_el: int = 2,  # bf16 activations
    activation_factor: float = 3.0,  # fwd + grads + workspace
) -> MemoryEstimate:
    """Closed-form activation/parameter accounting of the RetinaUNet."""
    dim = len(patch_size)
    num_stages = len(conv_kernels)
    channels = encoder_channels(num_stages, start_channels, max_channels)
    strides_abs = encoder_strides(num_stages, strides, dim)
    dec_channels = ufpn_out_channels(num_stages, decoder_levels, fpn_channels)

    def stage_voxels(stage):
        return int(
            np.prod([int(np.ceil(p / s)) for p, s in zip(patch_size, strides_abs[stage])])
        )

    # encoder: 2 convs per stage
    enc = sum(2 * stage_voxels(s) * channels[s] for s in range(num_stages))
    # decoder: lateral + upsample per level
    dec = sum(2 * stage_voxels(s) * dec_channels[s] for s in range(num_stages))
    # heads: towers on decoder levels (classifier + regressor, 2+ convs each)
    heads = sum(
        2 * 2 * stage_voxels(s) * head_channels for s in decoder_levels
    )
    # head outputs
    outs = sum(
        stage_voxels(s) * anchors_per_loc * (num_classes + 2 * dim)
        for s in decoder_levels
    )
    seg = stage_voxels(0) * 2
    act_bytes = (
        (enc + dec + heads + outs + seg)
        * batch_size
        * bytes_per_el
        * activation_factor
    )

    # parameters: rough conv accounting (kernels ~3^dim)
    param_count = 0
    for s in range(num_stages):
        cin = in_channels if s == 0 else channels[s - 1]
        param_count += (cin * channels[s] + channels[s] * channels[s]) * 3**dim
        param_count += channels[s] * dec_channels[s]  # lateral
    param_count += 2 * (fpn_channels * head_channels + head_channels * head_channels) * 3**dim
    # params + grads + SGD momentum, fp32
    param_bytes = param_count * 4 * 3

    # anchors/matching workspace: IoU [G, A] fp32 etc.
    anchors_total = sum(stage_voxels(s) * anchors_per_loc for s in decoder_levels)
    match_bytes = batch_size * anchors_total * (32 * 4 + 2 * dim * 4)

    total = int(act_bytes + param_bytes + match_bytes)
    return MemoryEstimate(
        total_bytes=total,
        breakdown={
            "activations": int(act_bytes),
            "params_opt": int(param_bytes),
            "matching": int(match_bytes),
        },
    )


def probe_batch(model_cfg, batch_size: int, max_instances: int, device: torch.device,
                seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded prepared batch of the shapes the JAX probe compiles for:
    ``images [B, *patch, C]`` float32 noise, ``max_instances`` GT slots
    (``gt_boxes``, ``gt_classes``, ``gt_mask``) and ``seg``. Each image holds
    one cube of class 0 around a random centre, made into targets by
    :func:`prepare_targets` as a loader batch is."""
    from nndetection_tpu_torch.data.gt_prep import prepare_targets

    rng = np.random.RandomState(seed)
    patch = tuple(model_cfg.patch_size)
    r = max(1, min(patch) // 8)
    seg = np.zeros((batch_size, *patch), np.int32)
    for b in range(batch_size):
        c = [rng.randint(r, g - r + 1) for g in patch]
        seg[(b, *(slice(ci - r, ci + r) for ci in c))] = 1
    table = np.full((batch_size, max_instances), -1, np.int32)
    table[:, 0] = 0
    images = rng.standard_normal((batch_size, *patch, model_cfg.in_channels)).astype(np.float32)
    return prepare_targets(*(torch.from_numpy(a).to(device) for a in (images, seg, table)))


def probe_train_step_estimate(
    model_cfg,
    batch_size: int,
    max_instances: int = 32,
    device: Union[torch.device, str] = "cuda",
) -> Optional[MemoryEstimate]:
    """The peak memory of the candidate's real train step, measured on the
    card.

    Builds the port's :class:`Trainer` for ``model_cfg`` at ``batch_size``
    (the same SGD with clipping, dtype and remat as the config), takes one
    step on a seeded batch of :func:`probe_batch` (it allocates the
    momentum), resets the allocator's peak, takes two more and returns
    ``max_memory_allocated()`` less what was allocated before the trainer
    existed. ``breakdown`` holds ``allocated_peak``, ``reserved_peak`` (the
    allocator's cache emptied before the probe), ``baseline`` (bytes) and
    ``step_ms`` (the mean of the two steps).

    Only ``torch.cuda.OutOfMemoryError`` is caught: it gives an
    ``out_of_memory`` estimate, which fits no budget. Any other error
    raises. A CPU ``device`` has no allocator to read and gives ``None``;
    without a card the default raises. Everything the probe allocated is
    freed before it returns."""
    from nndetection_tpu_torch import resolve_device
    from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    trainer = state = batch = None
    # what the cache holds from earlier work would count as reserved
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    baseline = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        trainer = Trainer(model_cfg, TrainerConfig(batch_size=batch_size), device=dev)
        state = trainer.init_state(rng_seed=0)
        batch = probe_batch(model_cfg, batch_size, max_instances, dev)
        generator = torch.Generator(device=dev).manual_seed(0)
        trainer.train_step(state, batch, generator)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.train_step(state, batch, generator)
        torch.cuda.synchronize(dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / 2
        out_of_memory = False
    except torch.cuda.OutOfMemoryError:
        step_ms, out_of_memory = float("nan"), True
    peak = torch.cuda.max_memory_allocated(dev)
    reserved = torch.cuda.max_memory_reserved(dev)
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return MemoryEstimate(
        total_bytes=int(peak - baseline),
        breakdown={"allocated_peak": int(peak), "reserved_peak": int(reserved),
                   "baseline": int(baseline), "step_ms": step_ms},
        out_of_memory=out_of_memory,
    )
