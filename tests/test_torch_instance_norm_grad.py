"""Backward of the port's instance norm (``InstanceNormFunction`` and the
gradient wrappers ``in_grad_stats``/``in_grad_input``) against the JAX
package: ``jax.grad`` of the JAX ``InstanceNorm`` module under its default
``plane_sub:8`` schedule and under ``NNDET_IN_STATS=two_pass``, and the
custom VJP of the Pallas ``fused_instance_norm`` in interpret mode. On the
CPU the Function runs the plain versions; the Triton kernels are held to
them on the card (``cuda`` marker and ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu.ops.pallas_norm import fused_instance_norm
from nndetection_tpu_torch.models.conv import ConvNormAct, InstanceNorm
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops.instance_norm import (
    InstanceNormFunction,
    in_grad_input,
    in_grad_input_plain,
    in_grad_stats,
    in_grad_stats_plain,
    in_stats_plain,
    instance_norm,
    instance_norm_plain,
    plane_schedule,
)

torch.set_num_threads(1)

# float32: both sides sum the statistics and the gradient sums in float32,
# in different orders
RTOL = ATOL = 1e-5

SHAPES = [
    (2, 8, 8, 8, 8),      # D < 16: plane_sub:8 reads all planes
    (2, 32, 8, 8, 8),     # planes 4, 12, 20, 28
    (1, 20, 7, 5, 4),     # planes 4, 12; odd in-plane sizes
    (2, 64, 4, 4, 16),
    (2, 16, 12, 6),       # a 4-D map: exact statistics
]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape) * 2 + 1.5).astype(np.float32)
    x += np.linspace(0, 1, shape[1], dtype=np.float32).reshape(1, -1, *([1] * (len(shape) - 2)))
    gamma = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    beta = rng.standard_normal(shape[-1]).astype(np.float32)
    # upstream gradient; at 0.1 the float32 sums of dgamma over ~2000 voxels
    # stay within the stated tolerance whatever the summation order
    t = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return x, gamma, beta, t


def _port_grads(x, gamma, beta, t, plane_stride):
    xt, gt, bt = (torch.from_numpy(v).requires_grad_() for v in (x, gamma, beta))
    y = instance_norm(xt, gt, bt, plane_stride=plane_stride)
    (y * torch.from_numpy(t)).sum().backward()
    return [v.grad.numpy() for v in (xt, gt, bt)]


@pytest.mark.parametrize("schedule", [None, "two_pass"])
@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax_instance_norm(monkeypatch, schedule, shape):
    from nndetection_tpu.models.conv import InstanceNorm as JaxInstanceNorm

    if schedule is None:
        monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    else:
        monkeypatch.setenv("NNDET_IN_STATS", schedule)
    monkeypatch.delenv("NNDET_IN_IMPL", raising=False)
    x, gamma, beta, t = _inputs(shape, seed=shape[1])
    jmod = JaxInstanceNorm(dtype=jnp.float32)

    def loss(x, g, b):
        return jnp.sum(jmod.apply({"params": {"scale": g, "bias": b}}, x) * t)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x, gamma, beta)

    # the port module reads the schedule as the JAX one does
    tmod = InstanceNorm(shape[-1])
    tmod.weight.data = torch.from_numpy(gamma)
    tmod.bias.data = torch.from_numpy(beta)
    if len(shape) == 5:
        xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
        (tmod(xt).permute(0, 2, 3, 4, 1) * torch.from_numpy(t)).sum().backward()
        got = [xt.grad.permute(0, 2, 3, 4, 1).numpy(), tmod.weight.grad.numpy(),
               tmod.bias.grad.numpy()]
    else:  # the module is 3-D; a 4-D map goes through the function
        got = _port_grads(x, gamma, beta, t, plane_stride=None)
    for g, w, name in zip(got, want, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 8, 16, 16, 8), (2, 32, 32, 16), (2, 13, 17, 4)])
def test_grads_match_fused_pallas_vjp(shape):
    """Exact statistics against the Pallas custom VJP (``_grad_stats_kernel``
    and ``_dx_kernel`` in interpret mode; the last shape has no clean chunk
    and takes the wrapper's XLA backward)."""
    x, gamma, beta, t = _inputs(shape, seed=7)

    def loss(x, g, b):
        return jnp.sum(fused_instance_norm(x, g, b) * t)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    got = _port_grads(x, gamma, beta, t, plane_stride=None)
    for g, w, name in zip(got, want, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("shape,plane_stride", [
    ((2, 32, 3, 2, 3), 8),   # planes 4::8: only they get the correction terms
    ((2, 9, 3, 2, 3), 8),    # D < 16: all planes
    ((1, 12, 5, 4), 4),      # planes 2::4
    ((2, 6, 4, 3), None),
])
def test_gradcheck_float64(shape, plane_stride):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, dtype=torch.float64).requires_grad_()
    gamma = (torch.rand(shape[-1], generator=g, dtype=torch.float64) + 0.5).requires_grad_()
    beta = torch.randn(shape[-1], generator=g, dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, gm, bt: instance_norm(x, gm, bt, plane_stride=plane_stride), (x, gamma, beta))


def test_matches_autograd_of_plain_composite():
    """The Function's backward formulas against PyTorch's autograd through
    the plain forward, plane_sub:8."""
    x, gamma, beta, t = _inputs((2, 32, 6, 5, 8), seed=3)
    got = _port_grads(x, gamma, beta, t, plane_stride=8)
    xt, gt, bt = (torch.from_numpy(v).requires_grad_() for v in (x, gamma, beta))
    (instance_norm_plain(xt, gt, bt, plane_stride=8) * torch.from_numpy(t)).sum().backward()
    for g, w in zip(got, (xt.grad, gt.grad, bt.grad)):
        np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, atol=ATOL)


def test_plain_grad_wrappers_formula():
    """``in_grad_input_plain``: planes outside ``start::step`` take no
    correction; with all planes the sums of dx over each (b, c) vanish."""
    x, gamma, _, t = _inputs((2, 16, 6, 4), seed=4)
    x4, dy = torch.from_numpy(x).double(), torch.from_numpy(t).double()
    mean, var = in_stats_plain(x4, 0, 1)
    inv = torch.rsqrt(var + 1e-5)
    s1, s2 = in_grad_stats(x4, dy, mean, inv)
    g = torch.from_numpy(gamma).double()
    dx = in_grad_input(x4, dy, mean, inv, g, s1, s2, 0, 1)
    assert dx.sum(dim=(1, 2)).abs().max() < 1e-9
    mean, var = in_stats_plain(x4, 2, 4)
    inv = torch.rsqrt(var + 1e-5)
    s1, s2 = in_grad_stats_plain(x4, dy, mean, inv)
    dx = in_grad_input_plain(x4, dy, mean, inv, g, s1, s2, 2, 4)
    off = [p for p in range(16) if (p - 2) % 4 != 0]
    torch.testing.assert_close(dx[:, off], (g * inv)[:, None, None] * dy[:, off])


def _autograd_nodes(t: torch.Tensor):
    """The autograd nodes reachable from ``t``."""
    seen, stack = [], [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and node not in seen:
            seen.append(node)
            stack.extend(n for n, _ in node.next_functions)
    return seen


def test_output_goes_through_the_function():
    mod = InstanceNorm(4)
    x = torch.randn(1, 4, 16, 3, 3).contiguous(memory_format=torch.channels_last_3d)
    y = mod(x.requires_grad_())
    forward_classes = [getattr(n, "_forward_cls", None) for n in _autograd_nodes(y)]
    assert forward_classes.count(InstanceNormFunction) == 1


def test_relu_in_place_after_the_norm():
    """``ConvNormAct`` applies ``relu_`` to the norm's output; the Function
    saves its input, not its output, so the backward still runs and agrees
    with autograd through the plain composite (float64)."""
    torch.manual_seed(0)
    layer = ConvNormAct(3, 4, 3).double()
    x = torch.randn(2, 3, 16, 6, 6, dtype=torch.float64)
    x = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
    y = layer(x)
    y.square().sum().backward()
    got = [x.grad.clone()] + [p.grad.clone() for p in layer.parameters()]

    conv, norm = layer.Conv_0, layer.InstanceNorm_0
    h = conv(x).permute(0, 2, 3, 4, 1)
    ref = torch.relu(instance_norm_plain(h, norm.weight, norm.bias, plane_stride=8))
    want = torch.autograd.grad(ref.square().sum(), [x] + list(layer.parameters()))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_cpu_backward_launches_no_kernel():
    before = dict(LAUNCHES)
    x, gamma, beta, t = _inputs((1, 16, 4, 4, 4), seed=5)
    _port_grads(x, gamma, beta, t, plane_stride=8)
    assert dict(LAUNCHES) == before


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plane_stride", [None, 8])
def test_triton_grad_kernels_match_plain(cuda_device, dtype, plane_stride):
    """Kernels #3 and #4 against their plain versions at the LUNA plan's
    stage-1 shape; float32 sums to 1e-4 relative, dx to one bfloat16 ulp."""
    g = torch.Generator().manual_seed(0)
    b, d, q, c = 2, 48, 64 * 64, 64
    x = (torch.randn(b, d, q, c, generator=g) * 2 + 1).to(cuda_device, dtype)
    dy = torch.randn(b, d, q, c, generator=g).to(cuda_device, dtype)
    gamma = (torch.rand(c, generator=g) + 0.5).to(cuda_device)
    start, step = plane_schedule(d, plane_stride)
    mean, var = in_stats_plain(x, start, step)
    inv = torch.rsqrt(var + 1e-5)
    n0 = LAUNCHES["in_grad_stats"], LAUNCHES["in_grad_input"]
    s1, s2 = in_grad_stats(x, dy, mean, inv)
    p1, p2 = in_grad_stats_plain(x, dy, mean, inv)
    dx = in_grad_input(x, dy, mean, inv, gamma, p1, p2, start, step)
    pdx = in_grad_input_plain(x, dy, mean, inv, gamma, p1, p2, start, step)
    torch.cuda.synchronize()
    assert (LAUNCHES["in_grad_stats"], LAUNCHES["in_grad_input"]) == (n0[0] + 1, n0[1] + 1)
    torch.testing.assert_close(s1, p1, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(s2, p2, rtol=1e-4, atol=1e-2)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dx.float(), pdx.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_every_parameter_gets_a_finite_gradient_on_the_card(cuda_device):
    from nndetection_tpu_torch.models.retina_unet import RetinaUNet
    from tests.test_torch_bridge import torch_cfg

    model = RetinaUNet(torch_cfg(), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    x = torch.randn(2, 32, 32, 32, 1, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    out = model(x)
    sum(v.float().square().mean() for v in out.values()).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
