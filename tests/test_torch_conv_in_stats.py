"""The fused conv + instance-norm statistics of the PyTorch port
(``ops/conv_in_stats.py``) against the JAX package's
``ops/pallas_conv.py``: the forward against ``conv3d_in_stats`` (its Pallas
kernel in interpret mode), the gradients of
``ConvInstanceNormFunction`` against ``jax.grad`` through the custom VJP,
and the ``supported`` predicate. On the CPU the port runs its plain
version; the CUDA kernel is held to it on the card (``cuda`` marker and
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu.ops.pallas_conv import conv3d_in_stats as jax_conv3d_in_stats
from nndetection_tpu.ops.pallas_conv import supported as jax_supported
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops import conv_in_stats as cis

torch.set_num_threads(1)

# y: both sides sum the same bf16 products in float32 and round once to
# bf16; another summation order can move a value across a rounding
# boundary, so one bf16 ulp (2^-7 relative at the bottom of a binade) plus
# the float32 summation error near zero
Y_RTOL, Y_ATOL = 2.0 ** -7, 1e-6
# statistics of the same bf16 y in float32: the Pallas kernel's shifted
# one-pass sums against the plain two-pass; a y off by one ulp at one voxel
# moves its mean by ulp / N
STAT_RTOL, STAT_ATOL = 1e-5, 1e-5
# gradients of x and w are bf16 (the conv VJP's output) on both sides; the
# JAX VJP also rounds the normalisation's cotangent to bf16 before it adds
# the statistics' cotangents (the port rounds once, after): two bf16 ulps of
# the largest entry
GRAD_XW_TOL = 2.0 ** -6
# gradients of gamma and beta: float32 sums of the same products
GRAD_AFFINE_TOL = 1e-5

SHAPES = [
    ((2, 8, 8, 8), 8, 16),
    ((1, 12, 16, 16), 16, 16),
    ((2, 6, 8, 8), 1, 8),  # stem-like C_in = 1
]


def _inputs(seed, shape, ci, co):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape,ci,co", SHAPES)
def test_forward_matches_jax(shape, ci, co):
    x, w = _inputs(0, shape, ci, co)
    y_j, mean_j, var_j = jax.device_get(jax_conv3d_in_stats(jnp.asarray(x), jnp.asarray(w)))
    y, mean, var = cis.conv3d_in_stats(torch.from_numpy(x), torch.from_numpy(w))
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (*shape, co)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j, np.float32),
                               rtol=Y_RTOL, atol=Y_ATOL)
    np.testing.assert_allclose(mean.numpy(), mean_j, rtol=STAT_RTOL, atol=STAT_ATOL)
    np.testing.assert_allclose(var.numpy(), var_j, rtol=STAT_RTOL, atol=STAT_ATOL)


def test_statistics_are_of_the_rounded_output():
    """Hazard: the statistics are of the bf16 y, not of the float32
    accumulator."""
    x, w = _inputs(3, (1, 4, 6, 6), 8, 8)
    y, mean, var = cis.conv3d_in_stats(torch.from_numpy(x), torch.from_numpy(w))
    yf = y.float()
    torch.testing.assert_close(mean, yf.mean(dim=(1, 2, 3)), rtol=0, atol=1e-6)
    torch.testing.assert_close(var, yf.var(dim=(1, 2, 3), unbiased=False), rtol=1e-6, atol=1e-6)
    acc = torch.nn.functional.conv3d(
        torch.from_numpy(x).bfloat16().float().permute(0, 4, 1, 2, 3),
        torch.from_numpy(w).bfloat16().float().permute(4, 3, 0, 1, 2), padding=1)
    assert not torch.equal(acc.mean(dim=(2, 3, 4)), mean)


def _normalise_jax(y, mean, var, gamma, beta, eps=1e-5):
    # InstanceNorm(x, stats=...) of the JAX package (models/conv.py:263-280)
    inv = jax.lax.rsqrt(var + eps)
    scale = inv * gamma
    shift = -mean * scale + beta
    return y * scale[:, None, None, None, :] + shift[:, None, None, None, :]


@pytest.mark.parametrize("ci", [8, 1])
def test_gradients_match_jax(ci):
    """Gradients of x, w, gamma and beta of one loss through the fused conv
    and the normalisation with its statistics, in a float32 model."""
    rng = np.random.default_rng(1)
    b, d, h, w_, co = 2, 6, 8, 8, 8
    x, w = _inputs(1, (b, d, h, w_), ci, co)
    gamma = (rng.random(co) + 0.5).astype(np.float32)
    beta = rng.normal(size=co).astype(np.float32)
    r = rng.normal(size=(b, d, h, w_, co)).astype(np.float32)

    def loss_jax(x, w, gamma, beta):
        y, mean, var = jax_conv3d_in_stats(x, w)
        return jnp.sum(jnp.tanh(_normalise_jax(y, mean, var, gamma, beta)) * r)

    want = jax.device_get(jax.grad(loss_jax, argnums=(0, 1, 2, 3))(x, w, gamma, beta))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()).requires_grad_()  # [Co, Ci, 3, 3, 3]
    tg = torch.from_numpy(gamma).requires_grad_()
    tb = torch.from_numpy(beta).requires_grad_()
    out = cis.conv_instance_norm(tx, tw, tg, tb, 1e-5, torch.float32)
    assert out.dtype == torch.float32
    (torch.tanh(out) * torch.from_numpy(r)).sum().backward()

    assert tx.grad.dtype == torch.float32 and tw.grad.dtype == torch.float32
    got = [tx.grad.numpy(), tw.grad.numpy().transpose(2, 3, 4, 1, 0), tg.grad.numpy(),
           tb.grad.numpy()]
    for name, g, wnt, tol in zip(("x", "w", "gamma", "beta"), got, want,
                                 (GRAD_XW_TOL, GRAD_XW_TOL, GRAD_AFFINE_TOL, GRAD_AFFINE_TOL)):
        wnt = np.asarray(wnt, np.float32)
        np.testing.assert_allclose(g, wnt, rtol=0, atol=tol * np.abs(wnt).max(), err_msg=name)
    # dx and dw are bf16 values (hazard: _bwd rounds to bf16), in float32
    for g in got[:2]:
        assert np.array_equal(g, torch.from_numpy(g).bfloat16().float().numpy())


def test_no_input_gradient_when_not_needed():
    x, w = _inputs(2, (1, 4, 6, 6), 1, 8)
    tw = torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()).requires_grad_()
    out = cis.conv_instance_norm(torch.from_numpy(x), tw, torch.ones(8), torch.zeros(8))
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    assert tw.grad is not None and torch.isfinite(tw.grad).all()


@pytest.mark.parametrize("x_shape,kernel,strides,dim", [
    ((2, 8, 16, 16, 8), (3, 3, 3), (1, 1, 1), 3),
    ((2, 8, 16, 16, 8), (3, 3, 3), (2, 2, 2), 3),
    ((2, 8, 16, 16, 8), (1, 1, 1), (1, 1, 1), 3),
    ((2, 8, 16, 16, 8), (3, 3), (1, 1), 2),
    ((2, 96, 128, 128, 32), (3, 3, 3), (1, 1, 1), 3),   # LUNA stage 0: 1 MiB plane
    ((2, 96, 128, 128, 64), (3, 3, 3), (1, 1, 1), 3),   # 2 MiB: the budget exactly
    ((1, 4, 192, 192, 32), (3, 3, 3), (1, 1, 1), 3),    # 2.25 MiB: over the budget
    ((1, 7, 181, 181, 32), (3, 3, 3), (1, 1, 1), 3),    # odd depth and plane
])
def test_supported_matches_jax(x_shape, kernel, strides, dim):
    assert cis.supported(x_shape, kernel, strides, dim) == jax_supported(
        x_shape, kernel, strides, dim)


def test_over_budget_plane_is_not_fused():
    """Hazard: the card has no VMEM limit, but the port fuses exactly where
    the JAX package does."""
    assert not cis.supported((1, 4, 192, 192, 32), (3, 3, 3), (1, 1, 1), 3)
    assert cis.supported((1, 4, 128, 128, 32), (3, 3, 3), (1, 1, 1), 3)


def test_pack_weight_layout():
    """Row k = tap * Ci + ci with tap = (dz * 3 + dy) * 3 + dx, zero padding
    beyond 27 * Ci rows and Co columns."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 3, 5)).astype(np.float32))
    p = cis.pack_weight(w, 32, 64)
    assert p.shape == (96, 64) and p.dtype == torch.bfloat16
    for dz, dy, dx, ci in [(0, 0, 0, 0), (1, 2, 0, 2), (2, 2, 2, 1)]:
        k = ((dz * 3 + dy) * 3 + dx) * 3 + ci
        torch.testing.assert_close(p[k, :5], w[dz, dy, dx, ci].bfloat16())
    assert not p[81:].any() and not p[:, 5:].any()


def test_cpu_wrapper_runs_the_plain_version(monkeypatch):
    calls = []
    plain = cis.conv3d_in_stats_plain
    monkeypatch.setattr(cis, "conv3d_in_stats_plain", lambda *a: calls.append(1) or plain(*a))
    x, w = _inputs(5, (1, 4, 6, 6), 8, 8)
    n0 = LAUNCHES["conv3d_in_stats"]
    cis.conv3d_in_stats(torch.from_numpy(x), torch.from_numpy(w))
    assert calls == [1] and LAUNCHES["conv3d_in_stats"] == n0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ci,co", SHAPES + [((2, 24, 32, 32), 128, 128),
                                                 ((2, 3, 4, 4), 320, 320)])
def test_cuda_kernel_matches_plain(cuda_device, shape, ci, co):
    x, w = _inputs(6, shape, ci, co)
    x = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(w).to(cuda_device)
    n0 = LAUNCHES["conv3d_in_stats"]
    y, mean, var = cis.conv3d_in_stats(x, w)
    py, pmean, pvar = cis.conv3d_in_stats_plain(x, w)
    torch.cuda.synchronize()
    assert LAUNCHES["conv3d_in_stats"] == n0 + 1
    torch.testing.assert_close(y.float(), py.float(), rtol=Y_RTOL, atol=1e-3)
    torch.testing.assert_close(mean, pmean, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(var, pvar, rtol=1e-3, atol=1e-4)
