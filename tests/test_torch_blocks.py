"""The model blocks that no plan builds, in the PyTorch port against the JAX
package: ``StackedResidualBlock`` and ``SELayer``
(``nndetection_tpu_torch/models/blocks.py``) and ``PAUFPN``
(``models/decoder.py``), 2D and 3D, float32, each with the flax parameters of
its JAX ``init`` through the bridge (the flax scope names are the port's
submodule names); and the bridge's checks on a PAUFPN tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu.models.blocks import SELayer as JSELayer
from nndetection_tpu.models.blocks import StackedResidualBlock as JResBlock
from nndetection_tpu.models.decoder import PAUFPN as JPAUFPN
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch.models.blocks import SELayer, StackedResidualBlock
from nndetection_tpu_torch.models.decoder import PAUFPN
from tests.test_torch_bridge import load_scoped

torch.set_num_threads(1)

TOL = 1e-4  # float32: XLA's and PyTorch's CPU convolutions sum in other orders


def to_port(x: np.ndarray) -> torch.Tensor:
    """Channel-last NumPy map -> ``[B, C, *spatial]`` in channel-innermost memory."""
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1)


def to_cl(y: torch.Tensor) -> np.ndarray:
    return y.movedim(1, -1).detach().numpy()


def perturbed(params, seed=1):
    """The JAX init's tree with every leaf moved by noise: non-zero biases,
    norm scales off 1."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda v: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(
        np.float32), jax.device_get(params))


@pytest.mark.parametrize("dim,cin,cout,stride,num_convs", [
    (3, 8, 8, None, 2),       # identity shortcut
    (3, 4, 8, None, 2),       # channels change: projected
    (3, 8, 8, 2, 3),          # strided: projected
    (3, 4, 8, (1, 2, 2), 2),  # anisotropic stride
    (2, 4, 8, 2, 2),
    (2, 8, 8, None, 1),
])
def test_residual_block_matches_jax(dim, cin, cout, stride, num_convs):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, *([12] * dim), cin)).astype(np.float32)
    mod = JResBlock(out_channels=cout, stride=stride, num_convs=num_convs, dim=dim,
                    dtype=jnp.float32)
    params = perturbed(mod.init(jax.random.PRNGKey(0), x))
    want = np.asarray(mod.apply(params, x))
    block = StackedResidualBlock(cin, cout, stride=stride, num_convs=num_convs, dim=dim)
    n_proj = num_convs + (1 if block.projected else 0)
    assert set(params["params"]) == {f"ConvNormAct_{i}" for i in range(n_proj)}
    got = to_cl(load_scoped(block, "block", params["params"])(to_port(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dim,channels,reduction", [(3, 32, 16), (2, 24, 4), (3, 8, 16)])
def test_se_layer_matches_jax(dim, channels, reduction):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, *([6] * dim), channels)).astype(np.float32) + 0.5
    mod = JSELayer(reduction=reduction, dtype=jnp.float32)
    params = perturbed(mod.init(jax.random.PRNGKey(2), x))
    want = np.asarray(mod.apply(params, x))
    layer = SELayer(channels, reduction)
    assert layer.Dense_0.out_features == max(1, channels // reduction)
    got = to_cl(load_scoped(layer, "se", params["params"])(to_port(x)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_se_layer_init_matches_flax_statistics():
    """Dense kernels lecun-normal (a normal truncated at 2 of its std,
    scaled so that the samples' std is 1/sqrt(fan_in)) and zero biases."""
    layer = SELayer(512, 2)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    w = layer.Dense_0.weight.detach()
    assert float(w.abs().max()) <= 2 * (1 / 512) ** 0.5 / 0.87962566103423978 + 1e-6
    assert abs(float(w.std()) * 512 ** 0.5 - 1.0) < 0.05
    assert not layer.Dense_0.bias.any() and not layer.Dense_1.bias.any()


def paufpn_case(dim, rng):
    if dim == 3:
        strides = ((1, 1, 1), (2, 2, 2), (4, 4, 4))
        kernels = ((3, 3, 3),) * 3
        sizes = [16, 8, 4]
    else:
        strides = ((1, 1), (2, 2), (4, 4), (8, 8))
        kernels = ((3, 3),) * 4
        sizes = [32, 16, 8, 4]
    channels = [8 * 2 ** i for i in range(len(sizes))]
    fmaps = [rng.standard_normal((2, *([s] * dim), c)).astype(np.float32)
             for s, c in zip(sizes, channels)]
    return strides, kernels, channels, fmaps


@pytest.mark.parametrize("dim,decoder_levels", [(3, (1, 2)), (2, (2, 3)), (2, (1, 2, 3))])
def test_paufpn_matches_jax(dim, decoder_levels):
    rng = np.random.RandomState(3)
    strides, kernels, channels, fmaps = paufpn_case(dim, rng)
    mod = JPAUFPN(strides=strides, conv_kernels=kernels, decoder_levels=decoder_levels,
                  fixed_out_channels=16, dim=dim, dtype=jnp.float32)
    params = perturbed(mod.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in fmaps]))
    want = [np.asarray(o) for o in mod.apply(params, [jnp.asarray(f) for f in fmaps])]
    dec = PAUFPN(channels, strides, kernels, decoder_levels, 16, dim=dim)
    n = len(fmaps)
    assert set(params["params"]) == (
        {f"lateral_P{i}_0" for i in range(n)} | {f"up_P{i}" for i in range(1, n)}
        | {f"pa_fusion_P{i}_0" for i in range(1, n)} | {f"down_P{i}" for i in range(n - 1)})
    load_scoped(dec, "decoder", params["params"])
    got = [to_cl(o) for o in dec([to_port(f) for f in fmaps])]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.shape[-1] for g in got] == dec.out_channels
    for level, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=f"level {level}")


def test_bridge_rejects_a_paufpn_tree_for_the_ufpn():
    """The U-FPN has no path-aggregation convs: the bridge names the first
    leaf it cannot place."""
    from nndetection_tpu_torch.models.decoder import UFPN

    rng = np.random.RandomState(4)
    strides, kernels, channels, fmaps = paufpn_case(3, rng)
    mod = JPAUFPN(strides=strides, conv_kernels=kernels, decoder_levels=(1, 2),
                  fixed_out_channels=16, dim=3, dtype=jnp.float32)
    params = mod.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in fmaps])
    holder = torch.nn.Module()
    holder.add_module("decoder", UFPN(channels, strides, (1, 2), 16))
    with pytest.raises(KeyError, match="down_P|pa_fusion_P"):
        bridge.state_dict_from_flax({"decoder": jax.device_get(params["params"])}, holder)
