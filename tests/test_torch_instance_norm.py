"""Instance norm of the PyTorch port (``ops/instance_norm.py`` and the
``InstanceNorm`` module) against the JAX package: the Pallas
``fused_instance_norm`` in interpret mode (exact statistics) and the JAX
``InstanceNorm`` module under its default ``plane_sub:8`` schedule and under
``NNDET_IN_STATS=two_pass``. On the CPU the port runs its plain versions; the
kernels are held to them on the card (``cuda`` marker,
``tests/test_torch_instance_norm_cuda.py`` and ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu.ops.pallas_norm import _pick_chunk, fused_instance_norm
from nndetection_tpu_torch.models.conv import InstanceNorm, in_plane_stride
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops.instance_norm import (
    in_stats_plain,
    instance_norm,
    instance_norm_plain,
    plane_schedule,
)

torch.set_num_threads(1)

# float32: both sides compute the statistics in float32 with different
# summation orders and the JAX module folds the affine differently
RTOL = ATOL = 1e-5


def _inputs(shape, seed, scale=2.0, shift=1.5):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    gamma = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    beta = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, gamma, beta


def _port(x, gamma, beta, **kw):
    return instance_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                         torch.from_numpy(beta), **kw).numpy()


@pytest.mark.parametrize("shape", [
    (2, 8, 16, 16, 8),
    (2, 32, 32, 16),
    (1, 16, 16, 16, 32),
    (2, 13, 17, 4),       # no clean chunk: the Pallas wrapper's XLA path
    (1, 5, 7, 3, 6),
])
def test_exact_matches_fused_pallas(shape):
    x, gamma, beta = _inputs(shape, seed=sum(shape))
    want = np.asarray(fused_instance_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    got = _port(x, gamma, beta)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_no_clean_chunk_case_is_covered():
    assert _pick_chunk(13 * 17, 4) == 0


def test_high_mean_low_variance():
    """Large mean, tiny variance (SNR 3e4): the f32 ulp of the mean is ~1% of
    sigma, so the criterion is the error against float64 truth, no worse
    than the Pallas kernel's."""
    rng = np.random.RandomState(2)
    xf64 = rng.standard_normal((1, 16, 16, 8)) * 1e-2 + 300.0
    x = xf64.astype(np.float32)
    gamma, beta = np.ones(8, np.float32), np.zeros(8, np.float32)
    truth = (xf64 - xf64.mean(axis=(1, 2), keepdims=True)) / np.sqrt(
        xf64.var(axis=(1, 2), keepdims=True) + 1e-5)
    pallas = np.asarray(fused_instance_norm(jnp.asarray(x), jnp.asarray(gamma),
                                            jnp.asarray(beta)), np.float64)
    got = _port(x, gamma, beta).astype(np.float64)
    assert np.isfinite(got).all()
    assert 0.9 < got.std() < 1.1
    err_port, err_pallas = np.abs(got - truth).max(), np.abs(pallas - truth).max()
    assert err_port <= max(2.0 * err_pallas, 1e-4), (err_port, err_pallas)


def test_bf16_matches_fused_pallas():
    """bfloat16 in and out. Both compute in float32 and round once to
    bfloat16, but their sums run in different orders, so a result next to a
    rounding boundary may land one bfloat16 ulp (2^-8 relative) apart:
    tolerance 1e-2 absolute + 1e-2 relative."""
    x, gamma, beta = _inputs((2, 16, 16, 16, 16), seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(fused_instance_norm(xb, jnp.asarray(gamma), jnp.asarray(beta)), np.float32)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    got = instance_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("schedule", [None, "two_pass"])
@pytest.mark.parametrize("shape", [
    (2, 8, 8, 8, 8),      # D < 16: plane_sub:8 falls back to all planes
    (2, 32, 8, 8, 8),     # planes 4, 12, 20, 28
    (1, 20, 7, 5, 4),     # planes 4, 12; no clean chunk
    (2, 64, 4, 4, 16),
])
def test_module_matches_jax_instance_norm(monkeypatch, schedule, shape):
    from nndetection_tpu.models.conv import InstanceNorm as JaxInstanceNorm

    if schedule is None:
        monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    else:
        monkeypatch.setenv("NNDET_IN_STATS", schedule)
    monkeypatch.delenv("NNDET_IN_IMPL", raising=False)
    x, gamma, beta = _inputs(shape, seed=shape[1])
    jmod = JaxInstanceNorm(dtype=jnp.float32)
    params = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))

    tmod = InstanceNorm(shape[-1])
    tmod.weight.data = torch.from_numpy(gamma)
    tmod.bias.data = torch.from_numpy(beta)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)  # channels_last_3d view
    assert xt.is_contiguous(memory_format=torch.channels_last_3d)
    got = tmod(xt).permute(0, 2, 3, 4, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plane_subsampling_changes_the_statistics(monkeypatch):
    """The default schedule reads planes 4::8 only: its output differs from
    the exact statistics on data whose planes differ."""
    x, gamma, beta = _inputs((1, 32, 4, 4, 4), seed=9)
    x += np.arange(32, dtype=np.float32)[None, :, None, None, None] * 0.1
    exact = _port(x, gamma, beta)
    sub = _port(x, gamma, beta, plane_stride=8)
    assert np.abs(exact - sub).max() > 1e-3
    mean, _ = in_stats_plain(torch.from_numpy(x).view(1, 32, 16, 4), 4, 8)
    np.testing.assert_allclose(mean.numpy()[0], x[0, 4::8].mean(axis=(0, 1, 2)), rtol=1e-6)


def test_plane_schedule_rule(monkeypatch):
    assert plane_schedule(96, 8) == (4, 8)
    assert plane_schedule(16, 8) == (4, 8)
    assert plane_schedule(15, 8) == (0, 1)
    assert plane_schedule(96, None) == (0, 1)
    monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    assert in_plane_stride(5) == 8
    assert in_plane_stride(4) is None
    monkeypatch.setenv("NNDET_IN_STATS", "two_pass")
    assert in_plane_stride(5) is None
    monkeypatch.setenv("NNDET_IN_STATS", "plane_sub")
    assert in_plane_stride(5) == 4
    monkeypatch.setenv("NNDET_IN_STATS", "plane_sub:2")
    assert in_plane_stride(5) == 2


def test_cpu_tensors_take_the_plain_version():
    x, gamma, beta = _inputs((1, 8, 4, 4, 8), seed=3)
    before = dict(LAUNCHES)
    a = _port(x, gamma, beta)
    b = instance_norm_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                            torch.from_numpy(beta)).numpy()
    np.testing.assert_array_equal(a, b)
    assert dict(LAUNCHES) == before


def test_non_viewable_input_raises():
    x = torch.randn(2, 8, 4, 4, 6).transpose(1, 2)  # not a channel-last map
    with pytest.raises(RuntimeError):
        instance_norm(x, torch.ones(6), torch.zeros(6))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plane_stride", [None, 8])
def test_triton_kernels_match_plain(cuda_device, dtype, plane_stride):
    """The statistics (CUDA C++) and apply (Triton) kernels against the
    plain version on the card, at the LUNA plan's stage-1 shape; float32 to
    1e-5, bfloat16 to one ulp."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 48, 64, 64, 64, generator=g) * 2 + 1).to(cuda_device, dtype)
    gamma = (torch.rand(64, generator=g) + 0.5).to(cuda_device)
    beta = torch.randn(64, generator=g).to(cuda_device)
    n0 = LAUNCHES["in_stats"], LAUNCHES["in_apply"]
    got = instance_norm(x, gamma, beta, plane_stride=plane_stride)
    want = instance_norm_plain(x, gamma, beta, plane_stride=plane_stride)
    torch.cuda.synchronize()
    assert (LAUNCHES["in_stats"], LAUNCHES["in_apply"]) == (n0[0] + 1, n0[1] + 1)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
