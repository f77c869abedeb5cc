"""The deep-supervision segmenter of the PyTorch port
(``RetinaUNetConfig.segmenter_deep_supervision``) against the JAX package:
the heads ``out_P{level}`` through the bridge, the outputs ``seg_logits`` and
``seg_logits_aux{i}``, the train-step losses (the segmentation loss is
``deep_supervision_seg_loss`` over the levels) and their gradients, float32,
on the tiny 3D configuration and the 2D one of ``tests/test_2d.py``, the JAX
sampler draws injected."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu.data.gt_prep import prepare_targets as j_prepare_targets
from nndetection_tpu.models import RetinaUNet as JaxRetinaUNet
from nndetection_tpu.models.retina_unet import train_step_loss as j_train_step_loss
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch.data.gt_prep import prepare_targets
from nndetection_tpu_torch.models.heads import DeepSupervisionSegmenter
from nndetection_tpu_torch.models.retina_unet import RetinaUNet, train_step_loss
from tests import test_torch_2d as t2d
from tests import test_torch_bridge as t3d
from tests.test_torch_train_loss import (
    inject_draws,
    jax_draws,
    numpy_params,
    pool_cap,
    tiny_batch,
)

torch.set_num_threads(1)

FWD_TOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
GRAD_TOL = 1e-3  # times max|g| of each tensor
LOSS_KEYS = ("cls", "reg", "seg_ce", "seg_dice", "num_pos", "num_neg")


def t(a):
    return torch.from_numpy(np.array(a))


def case(dim, levels):
    """``(JAX config, port config, overrides for numpy_params, batch)``."""
    ds = dict(segmenter_deep_supervision=True, seg_supervision_levels=levels)
    if dim == 3:
        images, seg, table = tiny_batch(2)
        return (t3d.jax_cfg(exact_topk=True, **ds), t3d.torch_cfg(**ds), ds,
                (images, seg, table))
    return (t2d.jax_cfg(exact_topk=True, **ds), t2d.torch_cfg(**ds), {**t2d.CFG_2D, **ds},
            t2d.batch_2d(2))


CASES = [(3, 3), (3, 2), (2, 3)]


@pytest.mark.parametrize("dim,levels", CASES)
def test_outputs_loss_and_gradients_match_jax(monkeypatch, dim, levels):
    monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    jcfg, tcfg, overrides, (images, seg, table) = case(dim, levels)
    params = numpy_params(0, **overrides)
    assert set(params["params"]["segmenter"]) == {f"out_P{i}" for i in range(levels)}
    targets = jax.device_get(j_prepare_targets(jnp.asarray(images), jnp.asarray(seg),
                                               jnp.asarray(table)))
    anchors, per_level = jcfg.anchors()
    key = jax.random.PRNGKey(2)

    def loss_fn(p):
        preds = JaxRetinaUNet(jcfg).apply(p, targets["images"])
        out = j_train_step_loss(jcfg, preds, jnp.asarray(anchors), per_level,
                                {k: jnp.asarray(v) for k, v in targets.items()}, key)
        return out["cls"] + out["reg"] + out["seg_ce"] + out["seg_dice"], (preds, out)

    (_, (want_preds, want)), want_grads = jax.device_get(
        jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params))

    model = RetinaUNet(tcfg)
    assert isinstance(model.segmenter, DeepSupervisionSegmenter)
    model.load_state_dict(bridge.state_dict_from_flax(params, model))
    preds = model(prepare_targets(t(images), t(seg), t(table))["images"])
    assert set(preds) == set(want_preds) == {
        "box_logits", "box_deltas", "seg_logits",
        *(f"seg_logits_aux{i}" for i in range(1, levels))}
    for k, w in want_preds.items():
        assert tuple(preds[k].shape) == w.shape, k
        np.testing.assert_allclose(preds[k].detach().numpy(), w, rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=k)
    assert preds["seg_logits_aux1"].shape[1] == tcfg.patch_size[0] // 2

    inject_draws(monkeypatch, jax_draws(key, 2, len(anchors), pool_cap(jcfg)))
    got = train_step_loss(tcfg, preds, t(anchors), per_level,
                          prepare_targets(t(images), t(seg), t(table)), torch.Generator())
    assert want["num_pos"] > 0 and float(got["seg_dice"]) == float(want["seg_dice"]) == 0.0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    (got["cls"] + got["reg"] + got["seg_ce"] + got["seg_dice"]).backward()
    grads = bridge.state_dict_from_flax(want_grads, model)
    for name, p in model.named_parameters():
        w = grads[name]
        torch.testing.assert_close(p.grad, w, rtol=0, atol=GRAD_TOL * float(w.abs().max()),
                                   msg=name)


def test_levels_beyond_the_decoder_are_dropped():
    """More supervised levels than decoder maps: one head per map, as the
    JAX segmenter's ``min(num_levels, len(fmaps))``."""
    seg = DeepSupervisionSegmenter([8, 16], seg_classes=1, num_levels=5)
    assert seg.num_levels == 2 and not hasattr(seg, "out_P2")
    fmaps = [torch.zeros(1, 8, 8, 8, 8), torch.zeros(1, 16, 4, 4, 4)]
    assert [tuple(o.shape) for o in seg(fmaps)] == [(1, 8, 8, 8, 2), (1, 4, 4, 4, 2)]
