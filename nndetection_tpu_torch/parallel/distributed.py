"""Multi-process training over ``torch.distributed`` (counterpart of
:mod:`nndetection_tpu.parallel.distributed`): one process per card, joined
into one process group, with host-side effects (checkpoints, logs, files)
left to process 0.

Environment contract (the JAX package's launcher contract):

``NNDET_COORDINATOR``    host:port of process 0 (absent => one process)
``NNDET_NUM_PROCESSES``  total process count
``NNDET_PROCESS_ID``     this process's rank

With a coordinator the group is built even at one process, so that one card
runs the same NCCL path as many. Collectives use NCCL on cards and gloo on
the CPU; a process's card is ``cuda:{rank % device_count}``. Without a
coordinator there is one process and no group: every helper answers for a
one-process job.

Rows of the global batch: the ranks form a ``(data, model)`` grid, rank =
``data_index * n_model + model_index`` (:mod:`nndetection_tpu_torch.parallel.mesh`).
Each data index feeds ``global_batch / n_data`` contiguous rows; the ranks
of one model group feed the same rows (their z-slabs of the same batch).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

MULTI_PROCESS_VARS = ("NNDET_COORDINATOR", "NNDET_NUM_PROCESSES", "NNDET_PROCESS_ID")
# minutes: a gloo group on a loaded host can take far longer than 30 s to
# form, and a rank that never comes must still end the job
DEFAULT_TIMEOUT_MIN = 10.0


def initialize_from_env(device: Union[torch.device, str] = "cuda") -> bool:
    """Join the job that ``NNDET_COORDINATOR`` / ``NNDET_NUM_PROCESSES`` /
    ``NNDET_PROCESS_ID`` describe, on ``device`` (the card unless the caller
    passes ``"cpu"``). True when a process group exists afterwards, False
    for the one-process case (no coordinator). Idempotent."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("NNDET_COORDINATOR")
    if not coord:
        return False
    missing = [v for v in MULTI_PROCESS_VARS[1:] if not os.environ.get(v)]
    if missing:
        raise RuntimeError(f"NNDET_COORDINATOR is set but {missing} are not")
    initialize(coord, int(os.environ["NNDET_NUM_PROCESSES"]),
               int(os.environ["NNDET_PROCESS_ID"]), device=device)
    return True


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device: Union[torch.device, str] = "cuda",
    backend: Optional[str] = None,
    timeout_min: Optional[float] = None,
) -> None:
    """``torch.distributed.init_process_group`` over ``tcp://`` on the
    coordinator, with an explicit timeout (``DEFAULT_TIMEOUT_MIN`` minutes
    unless ``timeout_min`` is given). The backend is NCCL on a card and
    gloo on the CPU unless ``backend`` names another (gloo lets several
    ranks share one card). On a card the rank's device becomes the current
    one; a card that is not there raises."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {process_id}: no CUDA device is available "
                               "(pass device='cpu' to train on the CPU)")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(
            minutes=DEFAULT_TIMEOUT_MIN if timeout_min is None else timeout_min),
    )


def rank_device(device: Union[torch.device, str]) -> torch.device:
    """This process's device: ``cuda:{rank % device_count}`` for a card,
    ``device`` itself otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", process_index() % torch.cuda.device_count())
    return dev


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on the process that owns host-side effects (checkpoints, logs,
    artifact exports)."""
    return process_index() == 0


def data_count(n_model: int = 1) -> int:
    """Size of the data axis: the processes over the model axis's size."""
    n = process_count()
    if n % n_model:
        raise ValueError(f"{n} processes do not split into model groups of {n_model}")
    return n // n_model


def data_index(n_model: int = 1) -> int:
    """This process's index on the data axis."""
    return process_index() // n_model


def local_batch_size(global_batch_size: int, n_model: int = 1) -> int:
    """Per-data-index share of the global batch. The global batch must
    divide evenly: dropping a remainder would skew the gradient."""
    n = data_count(n_model)
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes"
                         + (f" on the data axis (model axis {n_model})" if n_model > 1 else ""))
    return global_batch_size // n


def local_batch_slice(global_batch_size: int, n_model: int = 1) -> slice:
    """The contiguous rows of the global batch this process feeds."""
    per = local_batch_size(global_batch_size, n_model)
    i = data_index(n_model)
    return slice(i * per, (i + 1) * per)
