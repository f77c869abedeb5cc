"""The planner's peak-memory probe (``planning/estimator.py::
probe_train_step_estimate``) on the card, at the tiny configuration: a
positive peak with its breakdown, everything freed after, and an
out-of-memory error turned into a verdict that fits no budget. Imports
neither JAX nor the JAX package, so that it runs on a machine with the
card:

    python -m pytest -m cuda tests/test_torch_probe_cuda.py

Every test needs a CUDA device and skips without one."""
import pytest
import torch

import chip_smoke
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.planning.estimator import probe_train_step_estimate


@pytest.fixture
def cuda_device():
    """The card, after one probe: the libraries' handles (cuBLAS keeps its
    workspace in the caching allocator) are set up once per process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    probe_train_step_estimate(chip_smoke.tiny_cfg(), 2, device=dev)
    return dev


@pytest.mark.cuda
def test_probe_measures_the_step(cuda_device):
    before = torch.cuda.memory_allocated(cuda_device)
    LAUNCHES.clear()
    est = probe_train_step_estimate(chip_smoke.tiny_cfg(), 2, device=cuda_device)
    assert est.total_bytes > 0 and not est.out_of_memory
    b = est.breakdown
    assert b["baseline"] == before
    assert b["reserved_peak"] >= b["allocated_peak"] == b["baseline"] + est.total_bytes
    assert b["step_ms"] > 0
    missing = [k for k in chip_smoke.TRAIN_KERNELS if LAUNCHES.get(k, 0) == 0]
    assert missing == []
    assert torch.cuda.memory_allocated(cuda_device) == before  # everything freed
    more = probe_train_step_estimate(chip_smoke.tiny_cfg(), 4, device=cuda_device)
    assert more.total_bytes > est.total_bytes


@pytest.mark.cuda
def test_out_of_memory_is_a_verdict(cuda_device):
    before = torch.cuda.memory_allocated(cuda_device)
    total = torch.cuda.get_device_properties(cuda_device).total_memory
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(1e-4, cuda_device)
    try:
        est = probe_train_step_estimate(chip_smoke.tiny_cfg(), 2, device=cuda_device)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, cuda_device)
    assert est.out_of_memory and not est.fits(total)
    assert torch.cuda.memory_allocated(cuda_device) == before
