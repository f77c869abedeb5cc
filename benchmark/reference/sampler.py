"""Frozen copy, for the benchmark's reference, of the plain PyTorch code in
``nndetection_tpu_torch/core/boxes/sampler.py``; it imports nothing of the program.

Hard-negative anchor sampling with static shapes (counterpart of
:mod:`nndetection_tpu.core.boxes.sampler`), one row per image.

Uniform random priorities per anchor and a top-k with a static cap select
the sample; the dynamic counts (which depend on the number of positives)
enter only through comparisons with ranks. Every random number comes from
:func:`draw_uniform`, in a fixed order (positives, then the negative pool),
so that a test can substitute the draws of ``jax.random.uniform`` and hold
the samplers to the JAX package's.

* positives: uniform without replacement, ``min(#pos, batch_size * fraction)``;
* negatives: the ``num_neg * pool_size`` highest-scoring negatives, then
  uniform without replacement from that pool, with
  ``num_neg = clamp(max(1, num_pos) * (1/fraction - 1), min_neg, #neg)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .boxes import stable_topk


def draw_uniform(generator: torch.Generator, shape: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """Uniform ``[0, 1)`` float32 of ``shape`` from ``generator`` (drawn on the
    generator's device), on ``device``. The samplers' only source of
    randomness."""
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def _scatter_mask(idx: torch.Tensor, take: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, n]`` bool mask, True at ``idx`` where ``take``."""
    mask = torch.zeros(idx.shape[:-1] + (n + 1,), dtype=torch.bool, device=idx.device)
    mask.scatter_(-1, torch.where(take, idx, n), True)
    return mask[..., :n]


def _select_topk_mask(u: torch.Tensor, eligible: torch.Tensor, num_select: torch.Tensor,
                      cap: int) -> torch.Tensor:
    """Uniformly select ``min(num_select, #eligible)`` of the eligible entries
    of each row (at most ``cap``), by the priorities ``u``."""
    vals, idx = stable_topk(torch.where(eligible, u, -torch.inf), cap)
    ranks = torch.arange(cap, device=u.device)
    take = (ranks < num_select[..., None]) & torch.isfinite(vals)
    return _scatter_mask(idx, take, eligible.shape[-1])


class HardNegativeSamplerBatched:
    """Hard negative mining of the reference's default (``sampler.py:212-270``
    of nnDetection), on ``[B, N]`` labels and scores, one image per row."""

    def __init__(self, batch_size_per_image: int = 32, positive_fraction: float = 0.33,
                 min_neg: int = 1, pool_size: float = 20.0, batch_size: int = 1):
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.min_neg = min_neg
        self.pool_size = pool_size
        self.batch_size = batch_size
        total = batch_size_per_image * batch_size
        self.pos_cap = max(1, int(total * positive_fraction))
        neg_per_pos = abs(1.0 - 1.0 / positive_fraction)
        self.neg_cap = max(min_neg, int(max(1, self.pos_cap) * neg_per_pos) + 1)
        self.pool_cap = max(self.neg_cap, int(self.neg_cap * pool_size))

    def _num_neg(self, num_pos: torch.Tensor, num_neg_avail: torch.Tensor) -> torch.Tensor:
        neg_per_pos = abs(1.0 - 1.0 / self.positive_fraction)
        num_neg = (num_pos.clamp(min=1) * neg_per_pos).to(torch.int64)  # float32 product
        return torch.minimum(num_neg_avail, num_neg.clamp(min=self.min_neg))

    def __call__(self, generator: torch.Generator, target_labels: torch.Tensor,
                 fg_probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``target_labels [B, N]`` (>= 1 fg, 0 bg, -1 ignore), ``fg_probs
        [B, N]`` -> ``(pos_mask, neg_mask)``, each ``[B, N]`` bool."""
        b, n = target_labels.shape
        dev = target_labels.device
        positive = target_labels >= 1
        negative = target_labels == 0
        num_pos = positive.sum(-1).clamp(max=self.pos_cap)
        pos_mask = _select_topk_mask(draw_uniform(generator, (b, n), dev), positive, num_pos,
                                     self.pos_cap)

        num_neg_avail = negative.sum(-1)
        num_neg = self._num_neg(num_pos, num_neg_avail)
        # the hard-negative pool: the top (num_neg * pool_size) negatives
        pool_size = torch.minimum(num_neg_avail, (num_neg * self.pool_size).to(torch.int64))
        pool_vals, pool_idx = stable_topk(torch.where(negative, fg_probs, -torch.inf),
                                          self.pool_cap)
        pool_valid = ((torch.arange(self.pool_cap, device=dev) < pool_size[:, None])
                      & torch.isfinite(pool_vals))
        # uniform choice of num_neg from the pool
        chosen = _select_topk_mask(draw_uniform(generator, (b, self.pool_cap), dev), pool_valid,
                                   num_neg, self.neg_cap)
        neg_mask = torch.zeros_like(negative)
        neg_mask.scatter_(-1, pool_idx, chosen)
        return pos_mask, neg_mask


class BalancedHardNegativeSampler(HardNegativeSamplerBatched):
    """The same pool, with ``num_neg = max(num_pos, 1)``
    (``sampler.py:273-287`` of nnDetection)."""

    def _num_neg(self, num_pos, num_neg_avail):
        return torch.minimum(num_neg_avail, num_pos.clamp(min=1))


class HardNegativeSamplerFgAll(HardNegativeSamplerBatched):
    """All positives; ``negative_ratio * num_pos`` hard negatives
    (``sampler.py:290-338`` of nnDetection). One draw per call."""

    def __init__(self, negative_ratio: float = 1.0, pool_size: float = 20.0,
                 batch_size: int = 1, max_anchors: int = 1 << 16):
        super().__init__(batch_size_per_image=1, positive_fraction=0.5, min_neg=1,
                         pool_size=pool_size, batch_size=batch_size)
        self.negative_ratio = negative_ratio
        self.pos_cap = self.neg_cap = self.pool_cap = max_anchors

    def __call__(self, generator, target_labels, fg_probs):
        b, n = target_labels.shape
        dev = target_labels.device
        positive = target_labels >= 1
        negative = target_labels == 0
        num_neg_avail = negative.sum(-1)
        num_neg = torch.minimum(
            num_neg_avail,
            (self.negative_ratio * positive.sum(-1)).to(torch.int64).clamp(min=1))
        pool_size = torch.minimum(num_neg_avail, (num_neg * self.pool_size).to(torch.int64))
        cap = min(self.pool_cap, n)
        pool_vals, pool_idx = stable_topk(torch.where(negative, fg_probs, -torch.inf), cap)
        pool_valid = (torch.arange(cap, device=dev) < pool_size[:, None]) & torch.isfinite(pool_vals)
        chosen = _select_topk_mask(draw_uniform(generator, (b, cap), dev), pool_valid, num_neg, cap)
        neg_mask = torch.zeros_like(negative)
        neg_mask.scatter_(-1, pool_idx, chosen)
        return positive, neg_mask
