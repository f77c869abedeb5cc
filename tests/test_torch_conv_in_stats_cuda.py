"""The fused conv + instance-norm statistics kernel (#5,
``csrc/conv3d_in_stats.cu``) on the card against its plain version
``conv3d_in_stats_plain``, on every route of ``plan_conv``: the fused shapes
of the LUNA plan at batch 1-2, the tiny model's fused layers and the edge
shapes of ``chip_smoke.py``, each route forced where a shape allows it, and
two runs bit for bit equal. Imports neither JAX nor the JAX package, so that
it runs on a machine with the card:

    python -m pytest -m cuda tests/test_torch_conv_in_stats_cuda.py

Every test needs a CUDA device and skips without one."""
import pytest
import torch

import chip_smoke
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops import conv_in_stats as cis

# chip_smoke.py's stated tolerances: y within one bf16 ulp of the
# float64-summed plain conv; the statistics against two-pass float32
# statistics of the kernel's own y
Y_TOL = chip_smoke.TOL["conv_y"]
STATS_TOL = chip_smoke.TOL["conv_stats"]

# the LUNA plan's fused shapes at batch 2, stage 0b and stage 3 also at
# batch 1 (stage 3 then takes split-K)
LUNA = chip_smoke.CONV_SHAPES + [((1, 96, 128, 128, 32), 32), ((1, 12, 16, 16, 256), 256)]
SHAPES = LUNA + chip_smoke.TINY_FUSED_LAYERS + chip_smoke.CONV_EDGE_SHAPES
# a shape of each route run on the other routes it allows
FORCED = [
    (((2, 24, 32, 32, 128), 128), "im2col"),
    (((2, 24, 32, 32, 128), 128), "brick"),
    (((2, 6, 8, 8, 320), 320), "im2col"),
    (((2, 6, 8, 8, 320), 320), "split_k"),
    (((1, 8, 16, 32, 32), 32), "brick"),
    (((2, 16, 32, 64, 64), 16), "im2col"),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, xs, co, seed=0):
    g = torch.Generator().manual_seed(seed)
    ci = xs[-1]
    x = torch.randn(xs, generator=g).to(device, torch.bfloat16)
    w = (torch.randn((3, 3, 3, ci, co), generator=g) * (2.0 / (27 * ci)) ** 0.5).to(device)
    return x, w


def _close(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    bad = (got - want).abs() > atol + rtol * want.abs()
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements beyond rtol={rtol} atol={atol}, "
                           f"max abs err {(got - want).abs().max().item():.3e}")


def _check(x, w, plan):
    n0 = LAUNCHES["conv3d_in_stats"]
    y, mean, var = cis.conv3d_in_stats(x, w, plan)
    torch.cuda.synchronize()
    assert LAUNCHES["conv3d_in_stats"] == n0 + 1
    py, _, _ = cis.conv3d_in_stats_plain(x, w)
    assert y.dtype == torch.bfloat16 and y.shape == py.shape
    _close("y", y, py, **Y_TOL)
    yf = y.float()
    kmean = yf.mean(dim=(1, 2, 3))
    kvar = (yf - kmean[:, None, None, None]).square().mean(dim=(1, 2, 3))
    _close("mean", mean, kmean, **STATS_TOL)
    _close("var", var, kvar, **STATS_TOL)
    y2, mean2, var2 = cis.conv3d_in_stats(x, w, plan)
    assert torch.equal(y, y2) and torch.equal(mean, mean2) and torch.equal(var, var2)


@pytest.mark.cuda
@pytest.mark.parametrize("xs,co", SHAPES)
def test_kernel_matches_plain(cuda_device, xs, co):
    x, w = _inputs(cuda_device, xs, co)
    _check(x, w, None)


@pytest.mark.cuda
@pytest.mark.parametrize("case,route", FORCED)
def test_forced_route_matches_plain(cuda_device, case, route):
    xs, co = case
    plan = cis.plan_conv(xs, co, cis.sm_count(cuda_device), route=route)
    assert plan.route == route
    x, w = _inputs(cuda_device, xs, co, seed=1)
    _check(x, w, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", cis.BRICK_PIPELINES)
@pytest.mark.parametrize("xs,co", [((2, 24, 32, 32, 128), 128), ((2, 16, 32, 64, 64), 16)])
def test_brick_pipelines_match_plain(cuda_device, xs, co, pipeline):
    """Each (taps per step, weight buffers) of the brick, with four and two
    32-channel chunks of Ci: the next chunk's brick lands while this one
    runs."""
    plan = cis.plan_conv(xs, co, cis.sm_count(cuda_device), brick_pipeline=pipeline)
    assert plan.route == "brick"
    x, w = _inputs(cuda_device, xs, co, seed=2)
    _check(x, w, plan)


@pytest.mark.cuda
def test_plan_for_another_shape_raises(cuda_device):
    x, w = _inputs(cuda_device, (1, 8, 16, 16, 8), 16)
    with pytest.raises(ValueError):
        cis.conv3d_in_stats(x, w, cis.plan_conv((1, 8, 16, 16, 8), 32))
