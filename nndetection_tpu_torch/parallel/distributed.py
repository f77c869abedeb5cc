"""The one-process part of :mod:`nndetection_tpu.parallel.distributed`: the
port trains on one card in one process, so the process index is 0, the
process is the main one and its batch is the global batch.

A multi-process job (``NNDET_COORDINATOR``, ``NNDET_NUM_PROCESSES``,
``NNDET_PROCESS_ID``, the JAX package's launcher contract) raises: multi-GPU
training is not ported yet (``ROADMAP.md``, queue 1, multi-GPU)."""
from __future__ import annotations

import os

MULTI_PROCESS_VARS = ("NNDET_COORDINATOR", "NNDET_NUM_PROCESSES", "NNDET_PROCESS_ID")


def initialize_from_env() -> bool:
    """False: the port runs one process. Raises when the environment
    describes a multi-process job."""
    if os.environ.get("NNDET_COORDINATOR"):
        raise NotImplementedError(
            "NNDET_COORDINATOR is set: multi-process (multi-GPU) training is not ported "
            "(ROADMAP.md, queue 1, multi-GPU); unset it to train on one card")
    return False


def process_index() -> int:
    return 0


def process_count() -> int:
    return 1


def is_main_process() -> bool:
    return True


def local_batch_size(global_batch_size: int) -> int:
    return global_batch_size
