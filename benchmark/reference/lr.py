"""Frozen copy, for the benchmark's reference, of the plain PyTorch code in
``nndetection_tpu_torch/train/lr.py``; it imports nothing of the program.

Learning-rate schedules as plain functions of the step (counterpart of
:mod:`nndetection_tpu.train.lr`): linear warm-up then per-step poly decay,
and the cyclic-linear schedule of the SWA epochs."""
from __future__ import annotations

from typing import Callable

Schedule = Callable[[int], float]


def linear_warmup_poly_lr(initial_lr: float, warm_iterations: int, warm_lr: float,
                          poly_gamma: float, num_iterations: int) -> Schedule:
    """step -> lr; ``num_iterations`` includes the warm-up."""
    poly_iterations = max(1, num_iterations - warm_iterations)

    def schedule(step: int) -> float:
        if step < warm_iterations:
            return warm_lr + (initial_lr - warm_lr) * (step + 1.0) / max(warm_iterations, 1)
        it = min(max(step - warm_iterations, 0), poly_iterations - 1)
        return initial_lr * (1.0 - it / poly_iterations) ** poly_gamma

    return schedule


def cyclic_linear_lr(cycle_num_iterations: int, cycle_initial_lr: float,
                     cycle_final_lr: float) -> Schedule:
    """Linear decay from ``cycle_initial_lr`` to ``cycle_final_lr`` within
    each cycle."""

    def schedule(step: int) -> float:
        mult = 1.0 - (step % cycle_num_iterations) / cycle_num_iterations
        return cycle_final_lr + (cycle_initial_lr - cycle_final_lr) * mult

    return schedule


def swa_schedule(initial_lr: float, warm_iterations: int, warm_lr: float, poly_gamma: float,
                 train_iterations: int, swa_cycle_iterations: int) -> Schedule:
    """Warm-up + poly for the main run, then cyclic-linear ``initial_lr / 10
    -> initial_lr / 1000`` per cycle."""
    main = linear_warmup_poly_lr(initial_lr, warm_iterations, warm_lr, poly_gamma,
                                 train_iterations)
    cyc = cyclic_linear_lr(swa_cycle_iterations, initial_lr / 10.0, initial_lr / 1000.0)

    def schedule(step: int) -> float:
        return main(step) if step < train_iterations else cyc(step - train_iterations)

    return schedule
