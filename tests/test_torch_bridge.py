"""Parameter bridge from flax trees to the PyTorch port: the layout hazards
layer by layer (strided SAME convs, transposed-conv kernel flip, the group
norm's doubled scope), the whole tiny-model tree consumed exactly once, the
npz round trip, and the config's JSON round trip.

Also holds the tiny configuration and JAX-initialized parameters that the
other ``test_torch_*`` files share."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from nndetection_tpu_torch import bridge
from nndetection_tpu_torch.models import conv as tconv
from nndetection_tpu_torch.models.retina_unet import RetinaUNet, RetinaUNetConfig

torch.set_num_threads(1)

# the tiny configuration of __graft_entry__._tiny_cfg, at float32
TINY = dict(
    conv_kernels=((3, 3, 3),) * 4,
    strides=((2, 2, 2),) * 3,
    decoder_levels=(1, 2, 3),
    patch_size=(32, 32, 32),
    anchor_width=((4, 8),) * 3,
    anchor_height=((4, 8),) * 3,
    anchor_depth=((4, 8),) * 3,
    start_channels=8,
    fpn_channels=16,
    head_channels=16,
    topk_candidates=500,
    detections_per_img=20,
    dtype="float32",
)


def jax_cfg(**overrides):
    from nndetection_tpu.models import RetinaUNetConfig as JaxConfig

    return JaxConfig(**{**TINY, **overrides})


def torch_cfg(**overrides):
    return RetinaUNetConfig(**{**TINY, **overrides})


@functools.lru_cache(maxsize=None)
def jax_params(seed: int = 0):
    """``jax.device_get`` of the JAX model's ``init`` on the tiny config."""
    from nndetection_tpu.models import RetinaUNet as JaxRetinaUNet

    cfg = jax_cfg()
    x = np.zeros((1, *cfg.patch_size, 1), np.float32)
    return jax.device_get(jax.jit(JaxRetinaUNet(cfg).init)(jax.random.PRNGKey(seed), x))


def bridged_model(params, cfg=None) -> RetinaUNet:
    model = RetinaUNet(cfg or torch_cfg())
    model.load_state_dict(bridge.state_dict_from_flax(params, model))
    return model.eval()


def to_ncdhw(x_cl: np.ndarray) -> torch.Tensor:
    """Channel-last NumPy map -> [B, C, D, H, W] in channels_last_3d memory."""
    return torch.from_numpy(np.ascontiguousarray(x_cl)).permute(0, 4, 1, 2, 3)


def to_cl(y: torch.Tensor) -> np.ndarray:
    return y.permute(0, 2, 3, 4, 1).detach().numpy()


def load_scoped(layer: torch.nn.Module, scope: str, tree) -> torch.nn.Module:
    """Load a flax layer's tree into ``layer`` through the bridge, with the
    layer held under the flax scope name."""
    holder = torch.nn.Module()
    holder.add_module(scope, layer)
    holder.load_state_dict(bridge.state_dict_from_flax({scope: tree}, holder))
    return layer


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("size", [(16, 16, 16), (15, 16, 9), (8, 12, 5)])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (3, 1), (1, 1), (3, (1, 2, 2))])
def test_conv_same_padding(size, kernel, stride):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, *size, 4)).astype(np.float32)
    mod = fnn.Conv(6, (kernel,) * 3, strides=stride, padding="SAME", use_bias=True)
    params = mod.init(jax.random.PRNGKey(1), x)
    params = jax.tree.map(lambda p: p + 0.1, params)  # non-zero bias
    want = np.asarray(mod.apply(params, x))

    conv = tconv.Conv(4, 6, kernel, stride)
    got = to_cl(load_scoped(conv, "Conv_0", params["params"])(to_ncdhw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_symmetric_torch_padding_differs_on_strided_conv():
    """Pins the hazard: torch's padding=1 pads (1, 1) where XLA's SAME pads
    (0, 1) for k=3, s=2 on an even size, and shifts the output."""
    assert tconv.same_padding(16, 3, 2) == (0, 1)
    assert tconv.same_padding(15, 3, 2) == (1, 1)
    rng = np.random.RandomState(2)
    x = rng.standard_normal((1, 16, 16, 16, 2)).astype(np.float32)
    mod = fnn.Conv(3, (3, 3, 3), strides=2, padding="SAME", use_bias=False)
    params = mod.init(jax.random.PRNGKey(0), x)
    want = np.asarray(mod.apply(params, x))
    w = torch.from_numpy(np.asarray(params["params"]["kernel"]).transpose(4, 3, 0, 1, 2).copy())
    naive = to_cl(F.conv3d(to_ncdhw(x), w, stride=2, padding=1))
    assert np.abs(naive - want).max() > 0.1


@pytest.mark.parametrize("ratio", [(2, 2, 2), (1, 2, 2)])
def test_transposed_conv_kernel_flip(ratio):
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 4, 6, 5, 3)).astype(np.float32)
    mod = fnn.ConvTranspose(5, ratio, strides=ratio, padding="SAME", use_bias=True)
    params = mod.init(jax.random.PRNGKey(4), x)
    params = jax.tree.map(lambda p: p + 0.05, params)
    want = np.asarray(mod.apply(params, x))

    up = tconv.ConvTranspose(3, 5, ratio, ratio)
    got = to_cl(load_scoped(up, "ConvTranspose_0", params["params"])(to_ncdhw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if ratio == (2, 2, 2):
        # without the flip the result is wrong: pins the hazard
        k = np.asarray(params["params"]["kernel"]).transpose(3, 4, 0, 1, 2).copy()
        naive = to_cl(F.conv_transpose3d(to_ncdhw(x), torch.from_numpy(k),
                                         torch.from_numpy(np.asarray(params["params"]["bias"])),
                                         stride=ratio))
        assert np.abs(naive - want).max() > 0.1


def test_group_norm_doubled_scope():
    from nndetection_tpu.models.conv import GroupNorm as JaxGroupNorm

    rng = np.random.RandomState(5)
    x = (rng.standard_normal((2, 6, 5, 4, 32)) * 3 + 1).astype(np.float32)
    mod = JaxGroupNorm(dtype=jnp.float32)
    params = mod.init(jax.random.PRNGKey(0), x)
    assert set(bridge.flatten_tree(params["params"])) == {
        "GroupNorm_0/scale", "GroupNorm_0/bias"}
    params = {"params": {"GroupNorm_0": {
        "scale": rng.rand(32).astype(np.float32) + 0.5,
        "bias": rng.standard_normal(32).astype(np.float32)}}}
    want = np.asarray(mod.apply(params, x))

    gn = tconv.GroupNorm(32)
    assert set(gn.state_dict()) == {"GroupNorm_0.weight", "GroupNorm_0.bias"}
    load_scoped(gn, "GroupNorm_0", params["params"])
    assert gn.GroupNorm_0.num_groups == 2  # c // 16, contiguous
    got = to_cl(gn(to_ncdhw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ whole tree
def test_full_tree_consumed_exactly_once():
    params = jax_params()
    model = RetinaUNet(torch_cfg())
    sd = bridge.state_dict_from_flax(params, model)
    flat = bridge.flatten_tree(params["params"])
    assert len(flat) == len(sd) == len(model.state_dict())
    assert set(sd) == set(model.state_dict())
    # spot-check names and layouts
    k = flat["classifier/tower/conv0/GroupNorm_0/GroupNorm_0/scale"]
    np.testing.assert_array_equal(sd["classifier.tower.conv0.GroupNorm_0.GroupNorm_0.weight"], k)
    k = flat["encoder/stage1/ConvNormAct_0/Conv_0/kernel"]
    np.testing.assert_array_equal(sd["encoder.stage1.ConvNormAct_0.Conv_0.weight"],
                                  k.transpose(4, 3, 0, 1, 2))
    k = flat["decoder/up_P1/ConvTranspose_0/kernel"]
    np.testing.assert_array_equal(sd["decoder.up_P1.ConvTranspose_0.weight"],
                                  k[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))


def test_unconsumed_or_missing_leaf_raises():
    params = jax_params()["params"]
    model = RetinaUNet(torch_cfg())
    extra = {**params, "extra": {"kernel": np.zeros((1, 1, 1, 1, 1), np.float32)}}
    with pytest.raises(KeyError, match="extra"):
        bridge.state_dict_from_flax(extra, model)
    missing = {k: v for k, v in params.items() if k != "segmenter"}
    with pytest.raises(KeyError, match="segmenter"):
        bridge.state_dict_from_flax(missing, model)
    bad = dict(params)
    bad["regressor"] = dict(bad["regressor"], scales=np.ones(5, np.float32))
    with pytest.raises(ValueError, match="scales"):
        bridge.state_dict_from_flax(bad, model)


def test_npz_round_trip(tmp_path):
    params = jax_params()
    path = tmp_path / "params.npz"
    bridge.save_npz(path, params)
    loaded = bridge.load_npz(path)
    a, b = bridge.flatten_tree(params), bridge.flatten_tree(loaded)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    model = RetinaUNet(torch_cfg())
    sd1 = bridge.state_dict_from_flax(params, model)
    sd2 = bridge.state_dict_from_flax(loaded, model)
    for k in sd1:
        torch.testing.assert_close(sd1[k], sd2[k], rtol=0, atol=0)


def test_config_json_round_trip_matches_jax():
    jcfg = jax_cfg()
    tcfg = RetinaUNetConfig.from_dict(dataclasses.asdict(jcfg))
    assert tcfg == torch_cfg()
    assert RetinaUNetConfig.from_dict(tcfg.to_dict()) == tcfg
    assert {f.name for f in dataclasses.fields(tcfg)} == {
        f.name for f in dataclasses.fields(jcfg)}
    assert tcfg.compute_dtype == torch.float32
    assert RetinaUNetConfig().compute_dtype == torch.bfloat16
    assert tcfg.anchors_per_loc() == jcfg.anchors_per_loc()
    assert tcfg.feature_shapes() == jcfg.feature_shapes()
    with pytest.raises(ValueError, match="unknown"):
        RetinaUNetConfig.from_dict({"not_a_field": 1})
