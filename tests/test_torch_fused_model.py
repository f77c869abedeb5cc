"""The ``NNDET_CONV_FUSED=1`` configuration of the PyTorch port against the
JAX package's: ``StackedConvBlock`` with ``leaky_relu``, and the tiny
RetinaUNet (JAX parameters through the bridge) forward and one full train
step, fused on both sides. Each test proves that the fused path ran: on the
JAX side a counting wrapper around ``pallas_conv.conv3d_in_stats`` (which
``models/conv.py`` imports at call time), on the port's a count of its plain
version. Also the repairs that came with it: ``ConvNormAct(act="leaky_relu")``,
the conv's missing bias under a norm, and the entry points' device default.

The whole-model tests run at patch 8x32x32: on the CPU the JAX package runs
the Pallas kernel in interpret mode, whose body unrolls ``t_blk x 27``
products per depth block, and a 32x32x32 patch made the JAX forward alone
take ~90 s on one core."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nndetection_tpu.ops.pallas_conv as jax_pallas_conv
from nndetection_tpu.data.gt_prep import prepare_targets as j_prepare_targets
from nndetection_tpu.models import RetinaUNet as JaxRetinaUNet
from nndetection_tpu.models.blocks import StackedConvBlock as JaxStackedConvBlock
from nndetection_tpu.models.conv import ConvNormAct as JaxConvNormAct
from nndetection_tpu.models.retina_unet import train_step_loss as j_train_step_loss
from nndetection_tpu.train import trainer as jtrainer
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
from nndetection_tpu_torch.models import conv as tconv
from nndetection_tpu_torch.models.blocks import StackedConvBlock
from nndetection_tpu_torch.models.retina_unet import RetinaUNet
from nndetection_tpu_torch.ops import conv_in_stats
from nndetection_tpu_torch.train.trainer import Trainer, TrainerConfig
from tests.test_torch_bridge import jax_cfg, load_scoped, to_cl, to_ncdhw, torch_cfg
from tests.test_torch_train_loss import numpy_params

torch.set_num_threads(1)

PATCH = (8, 32, 32)
# fused layers of the tiny model (4 stages): both convs of stage 0 and the
# second conv of stages 1-3 (stride 1, 3x3x3, instance norm)
FUSED_LAYERS = 5
# The fused layers compute in bf16 on both sides, even in this float32
# model. An input that the two packages' float32 convolutions leave ~1e-6
# apart can round to neighbouring bf16 values, and the same products summed
# in another order can round y differently: one bf16 ulp (2^-8 relative) at
# a few voxels per layer, which the instance norms over few voxels in the
# deep stages amplify (measured: 0.2 % of the largest output, 5 % of the
# largest gradient at stage 3, which normalises over 16 voxels)
FWD_TOL = 1e-2  # times max|out| of each output
BLOCK_TOL = 1e-2
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-4
# gradients: the above, plus the conv VJP's bf16 output and the JAX VJP's
# extra rounding of the cotangent (test_torch_conv_in_stats.py); the mean
# error is held tighter than the largest
GRAD_TOL, GRAD_MEAN_TOL = 1e-1, 2e-2  # times max|g| resp. mean|g| of each tensor
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-4
STEP_TCFG = TrainerConfig(batch_size=2, warm_iterations=0, max_epochs=1,
                          num_train_batches_per_epoch=10, swa_epochs=0)


@pytest.fixture
def fused(monkeypatch):
    """``NNDET_CONV_FUSED=1`` and the counters of both fused paths."""
    monkeypatch.setenv("NNDET_CONV_FUSED", "1")
    monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    monkeypatch.delenv("NNDET_IN_IMPL", raising=False)
    calls = {"jax": 0, "port": 0}
    jax_fn, plain = jax_pallas_conv.conv3d_in_stats, conv_in_stats.conv3d_in_stats_plain

    def count_jax(*args):
        calls["jax"] += 1
        return jax_fn(*args)

    def count_port(*args):
        calls["port"] += 1
        return plain(*args)

    monkeypatch.setattr(jax_pallas_conv, "conv3d_in_stats", count_jax)
    monkeypatch.setattr(conv_in_stats, "conv3d_in_stats_plain", count_port)
    return calls


# --------------------------------------------------------------- layers
def test_conv_has_no_bias_under_a_norm():
    assert tconv.ConvNormAct(4, 8, norm="instance").Conv_0.bias is None
    assert tconv.ConvNormAct(4, 8, norm="group").Conv_0.bias is None
    assert tconv.ConvNormAct(4, 8, norm=None).Conv_0.bias is not None
    model = RetinaUNet(torch_cfg())
    for name, m in model.named_modules():
        if isinstance(m, tconv.ConvNormAct) and m.norm is not None and not m.transposed:
            assert m.Conv_0.bias is None, name


@pytest.mark.parametrize("norm", ["instance", None])
def test_leaky_relu_conv_norm_act_matches_jax(monkeypatch, norm):
    """Unfused: slope 0.01, as ``nn.leaky_relu(x, negative_slope=0.01)``."""
    monkeypatch.delenv("NNDET_CONV_FUSED", raising=False)
    monkeypatch.setenv("NNDET_IN_STATS", "two_pass")
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((2, 6, 8, 8, 4)) - 0.3).astype(np.float32)
    mod = JaxConvNormAct(out_channels=8, norm=norm, act="leaky_relu", dtype=jnp.float32)
    params = mod.init(jax.random.PRNGKey(0), x)
    want = np.asarray(mod.apply(params, x))
    assert (want < 0).any()
    layer = tconv.ConvNormAct(4, 8, norm=norm, act="leaky_relu")
    got = to_cl(load_scoped(layer, "root", params["params"]).eval()(to_ncdhw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_unknown_act_raises():
    with pytest.raises(ValueError, match="act"):
        tconv.ConvNormAct(4, 8, act="gelu")


def test_stacked_block_leaky_relu_fused_matches_jax(fused):
    rng = np.random.RandomState(2)
    x = rng.standard_normal((1, 8, 16, 16, 4)).astype(np.float32)
    blk = JaxStackedConvBlock(out_channels=8, dim=3, act="leaky_relu", dtype=jnp.float32)
    params = blk.init(jax.random.PRNGKey(0), x)
    fused["jax"] = 0  # init traced the block too
    want = np.asarray(jax.jit(blk.apply)(params, x))
    assert fused["jax"] == 2

    block = StackedConvBlock(4, 8, act="leaky_relu")
    load_scoped(block, "root", params["params"])
    got = block(to_ncdhw(x))
    assert fused["port"] == 2
    assert got.dtype == torch.float32  # hazard: the norm runs in the model's type
    np.testing.assert_allclose(to_cl(got), want, rtol=BLOCK_TOL, atol=BLOCK_TOL)


def test_float32_model_normalises_in_float32(fused):
    """Hazard: the fused conv is bf16 even in a float32 model, but the norm
    runs on the bf16 y upcast, so the output is not bf16-rounded."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.standard_normal((1, 4, 6, 6, 4)).astype(np.float32))
    layer = tconv.ConvNormAct(4, 8, act=None)
    with torch.no_grad():
        layer.InstanceNorm_0.weight.uniform_(0.5, 1.5)
    out = layer(x.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d))
    assert fused["port"] == 1
    assert out.dtype == torch.float32
    assert not torch.equal(out, out.bfloat16().float())


def test_over_budget_plane_stays_unfused(fused):
    """Hazard: a plane over the JAX package's 2 MiB budget takes the unfused
    conv and the plane-subsampled statistics on both sides."""
    layer = tconv.ConvNormAct(32, 32)
    x = torch.zeros((1, 32, 2, 192, 192)).contiguous(memory_format=torch.channels_last_3d)
    assert not layer._fused(x)
    assert layer._fused(x[:, :, :, :128, :128])
    assert not jax_pallas_conv.supported((1, 2, 192, 192, 32), (3, 3, 3), (1, 1, 1), 3)


# ---------------------------------------------------------- whole model
def _cfg(**overrides):
    return dict(patch_size=PATCH, exact_topk=True, **overrides)


def fused_batch(seed: int = 0, b: int = 2):
    """Images and instance segmentations with boxes inside an 8x32x32
    patch, as NumPy."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, *PATCH), np.int32)
    table = np.full((b, 4), -1, np.int32)
    for i in range(b):
        for iid in range(1, 3 if i else 2):
            lo = [rng.randint(1, 3), rng.randint(2, 20), rng.randint(2, 20)]
            ext = [rng.randint(3, 6), rng.randint(4, 11), rng.randint(4, 11)]
            seg[i, lo[0]:lo[0] + ext[0], lo[1]:lo[1] + ext[1], lo[2]:lo[2] + ext[2]] = iid
            table[i, iid - 1] = 0
    images = rng.standard_normal((b, *PATCH, 1)).astype(np.float32)
    return images, seg, table


def test_forward_fused_matches_jax(fused):
    cfg = jax_cfg(**_cfg())
    params = numpy_params()
    fused["jax"] = 0  # the parameters' shapes come from a trace of init
    x = np.random.RandomState(0).standard_normal((2, *PATCH, 1)).astype(np.float32)
    # a fresh jit: the JAX module reads the variable while it is traced
    want = jax.device_get(jax.jit(lambda p, v: JaxRetinaUNet(cfg).apply(p, v))(params, x))
    assert fused["jax"] == FUSED_LAYERS

    model = RetinaUNet(torch_cfg(**_cfg()))
    model.load_state_dict(bridge.state_dict_from_flax(params, model))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    assert fused["port"] == FUSED_LAYERS
    for key in ("box_logits", "box_deltas", "seg_logits"):
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=FWD_TOL * np.abs(want[key]).max(), err_msg=key)


@functools.lru_cache(maxsize=None)
def _jax_train_step():
    """Losses, clipped gradients and updated parameters of one JAX step of
    the ``no_sampler`` head on :func:`fused_batch` (traced under the caller's
    ``NNDET_CONV_FUSED=1``). The hard-negative heads rank negatives by score,
    and scores that differ at bf16 level pick other negatives."""
    cfg = jax_cfg(**_cfg(head_type="no_sampler"))
    params = numpy_params()
    anchors, per_level = cfg.anchors()
    out = j_prepare_targets(*map(jnp.asarray, fused_batch()))
    targets = {k: np.array(v) for k, v in out.items()}
    key = jax.random.PRNGKey(4)  # unused by the no_sampler head

    def loss_fn(p, batch):
        preds = JaxRetinaUNet(cfg).apply(p, batch["images"])
        out = j_train_step_loss(cfg, preds, jnp.asarray(anchors), per_level, batch, key)
        return out["cls"] + out["reg"] + out["seg_ce"] + out["seg_dice"], out

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in targets.items()})
    tx, _ = jtrainer.make_optimizer(jtrainer.TrainerConfig(**dataclasses.asdict(STEP_TCFG)))
    import optax

    clipped = optax.clip_by_global_norm(STEP_TCFG.grad_clip_norm).update(grads, None)[0]
    updates, _ = tx.update(grads, tx.init(params), params)
    return targets, key, jax.device_get((losses, clipped, optax.apply_updates(params, updates)))


def test_train_step_fused_matches_jax(fused):
    numpy_params()
    fused["jax"] = 0
    targets, _, (want_losses, want_grads, want_params) = _jax_train_step()
    assert fused["jax"] >= FUSED_LAYERS  # traced once more under remat
    cfg = torch_cfg(**_cfg(head_type="no_sampler"))
    trainer = Trainer(cfg, STEP_TCFG, device="cpu")
    model = RetinaUNet(cfg)
    state = trainer.init_state(params=bridge.state_dict_from_flax(numpy_params(), model))
    losses = trainer.train_step(state, trainer._to_device(targets), torch.Generator())
    # the encoder runs again in the backward (remat)
    assert fused["port"] == 2 * FUSED_LAYERS

    assert want_losses["num_pos"] > 0
    for k in ("cls", "reg", "seg_ce", "seg_dice", "num_pos", "num_neg"):
        np.testing.assert_allclose(float(losses[k]), float(want_losses[k]), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    grads = bridge.state_dict_from_flax(want_grads, model)
    for name, p in state.model.named_parameters():
        w = grads[name]
        torch.testing.assert_close(p.grad, w, rtol=0, atol=GRAD_TOL * float(w.abs().max()),
                                   msg=name)
        assert float((p.grad - w).abs().mean()) <= GRAD_MEAN_TOL * float(w.abs().mean()), name
    new = bridge.state_dict_from_flax(want_params, model)
    for name, p in state.model.state_dict().items():
        torch.testing.assert_close(p, new[name], rtol=PARAM_RTOL, atol=PARAM_ATOL, msg=name)


# ------------------------------------------------------- device default
def test_entry_points_default_to_the_card():
    """Without CUDA the entry points raise unless the caller passes "cpu";
    they never fall back to the CPU by themselves."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = torch_cfg()
    bundle = [ModelBundle(cfg=cfg, params=RetinaUNet(cfg).state_dict())]
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(bundle, tta=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, STEP_TCFG)
    assert Predictor(bundle, tta=False, device="cpu").device.type == "cpu"
    assert Trainer(cfg, STEP_TCFG, device="cpu").device.type == "cpu"
