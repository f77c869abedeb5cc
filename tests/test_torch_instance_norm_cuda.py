"""The instance-norm kernels on the card against their plain versions: the
statistics (#1, ``csrc/instance_norm_stats.cu``) at every LUNA stage shape
at batch 2 and 8, both schedules, float32, bfloat16 and float16, one launch
per call and two calls bit for bit equal, plus shapes off the 16-byte path;
the apply (#2), gradient sums (#3) and input gradient (#4) at the LUNA
stages. Imports neither JAX nor the JAX package, so that it runs on a
machine with the card:

    python -m pytest -m cuda tests/test_torch_instance_norm_cuda.py

Every test needs a CUDA device and skips without one."""
import pytest
import torch

import chip_smoke
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops import instance_norm as inorm

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
STAGES = [(batch,) + tuple(s[1:]) for batch in chip_smoke.IN_BATCHES
          for s in chip_smoke.LUNA_STAGES]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _map(device, shape, dtype, seed=0):
    b, d, h, w, c = shape
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((b, d, h * w, c), generator=g, device=device) * 2 + 1).to(dtype)


def _close(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    bad = (got - want).abs() > atol + rtol * want.abs()
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements beyond rtol={rtol} atol={atol}, "
                           f"max abs err {(got - want).abs().max().item():.3e}")


def _check_stats(x4, start, step):
    n0 = LAUNCHES["in_stats"]
    mean, var = inorm.in_stats(x4, start, step)
    torch.cuda.synchronize()
    assert LAUNCHES["in_stats"] == n0 + 1
    pmean, pvar = inorm.in_stats_plain(x4, start, step)
    assert mean.dtype == var.dtype == torch.float32 and mean.shape == pmean.shape
    _close("mean", mean, pmean, **chip_smoke.TOL["in_stats"])
    _close("var", var, pvar, **chip_smoke.TOL["in_stats"])
    mean2, var2 = inorm.in_stats(x4, start, step)
    assert torch.equal(mean, mean2) and torch.equal(var, var2)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [None, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STAGES)
def test_stats_match_plain(cuda_device, shape, dtype, stride):
    x4 = _map(cuda_device, shape, dtype)
    _check_stats(x4, *inorm.plane_schedule(shape[1], stride))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,planes", [
    ((1, 20, 5, 7, 6), (4, 8)),     # C = 6: one element per thread
    ((2, 16, 10, 20, 100), (4, 8)), # C = 100: a partial channel block
    ((1, 9, 3, 3, 1), (0, 1)),      # C = 1
    ((3, 5, 4, 4, 24), (0, 1)),     # C = 24: three 8-channel vectors
    ((1, 2, 1, 1, 8), (1, 1)),      # one row
])
def test_stats_odd_shapes(cuda_device, shape, planes, dtype):
    _check_stats(_map(cuda_device, shape, dtype, seed=1), *planes)


@pytest.mark.cuda
def test_stats_unaligned_map(cuda_device):
    """A contiguous map 2 bytes past a 16-byte boundary takes the
    one-element loads."""
    b, d, q, c = 2, 16, 64, 32
    flat = _map(cuda_device, (1, 1, 1, b * d * q * c + 1, 1), torch.bfloat16).flatten()
    x4 = flat[1:].view(b, d, q, c)
    assert x4.data_ptr() % 16 != 0
    _check_stats(x4, 4, 8)


@pytest.mark.cuda
def test_stats_workspace_grows_and_counters_stay_zero(cuda_device):
    """Calls of growing, shrinking and growing grids on one stream share the
    workspace; a stale counter would make a later call combine early."""
    for shape in [(1, 3, 4, 4, 320), (8, 96, 128, 128, 32), (2, 6, 8, 8, 320),
                  (2, 48, 64, 64, 64), (1, 3, 4, 4, 8)]:
        _check_stats(_map(cuda_device, shape, torch.bfloat16, seed=2), 0, 1)
    for ws_part, counters in inorm._stats_ws.values():
        assert not counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [None, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", chip_smoke.LUNA_STAGES)
def test_apply_and_backward_match_plain(cuda_device, shape, dtype, stride):
    """#2, #3 and #4 on the statistics of the plain version."""
    x4 = _map(cuda_device, shape, dtype, seed=3)
    dy4 = _map(cuda_device, shape, dtype, seed=4)
    c = shape[-1]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    gamma = torch.rand(c, generator=g, device=cuda_device) + 0.5
    beta = torch.randn(c, generator=g, device=cuda_device)
    start, step = inorm.plane_schedule(shape[1], stride)
    mean, var = inorm.in_stats_plain(x4, start, step)
    inv = torch.rsqrt(var + 1e-5)
    f32 = dtype == torch.float32
    n0 = {k: LAUNCHES[k] for k in ("in_apply", "in_grad_stats", "in_grad_input")}
    y = inorm.in_apply(x4, mean, var, gamma, beta)
    _close("apply", y, inorm.in_apply_plain(x4, mean, var, gamma, beta),
           **chip_smoke.TOL["in_apply_f32" if f32 else "in_apply_bf16"])
    s1, s2 = inorm.in_grad_stats(x4, dy4, mean, inv)
    p1, p2 = inorm.in_grad_stats_plain(x4, dy4, mean, inv)
    _close("s1", s1, p1, **chip_smoke.TOL["in_grad_stats"])
    _close("s2", s2, p2, **chip_smoke.TOL["in_grad_stats"])
    dx = inorm.in_grad_input(x4, dy4, mean, inv, gamma, p1, p2, start, step)
    _close("dx", dx, inorm.in_grad_input_plain(x4, dy4, mean, inv, gamma, p1, p2, start, step),
           **chip_smoke.TOL["in_grad_input_f32" if f32 else "in_grad_input_bf16"])
    torch.cuda.synchronize()
    assert all(LAUNCHES[k] == n + 1 for k, n in n0.items())
