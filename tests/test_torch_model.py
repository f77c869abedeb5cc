"""The PyTorch port's RetinaUNet forward and detection post-processing
against the JAX package on the tiny configuration: identical parameters from
the JAX ``init`` through the bridge, identical inputs from a NumPy seed,
float32. Also the box geometry (anchors, decode, clip, small-box mask)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu.core.boxes import ops as jops
from nndetection_tpu.core.boxes.coder import BoxCoder as JaxBoxCoder
from nndetection_tpu.models import RetinaUNet as JaxRetinaUNet
from nndetection_tpu.models import batched_postprocess as jax_batched_postprocess
from nndetection_tpu_torch.core.boxes import ops as tops
from nndetection_tpu_torch.core.boxes.coder import BoxCoder
from nndetection_tpu_torch.models.retina_unet import (
    RetinaUNet,
    batched_postprocess,
    postprocess_detections,
)
from tests.test_torch_bridge import bridged_model, jax_cfg, jax_params, torch_cfg

torch.set_num_threads(1)

# forward at float32: XLA's and PyTorch's CPU convolutions sum in different
# orders through 4 stages, a decoder and two heads
FWD_TOL = 1e-4


@pytest.mark.parametrize("schedule", [None, "two_pass"])
def test_forward_matches_jax(monkeypatch, schedule):
    if schedule is None:
        monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    else:
        monkeypatch.setenv("NNDET_IN_STATS", schedule)
    monkeypatch.delenv("NNDET_IN_IMPL", raising=False)
    params = jax_params()
    cfg = jax_cfg()
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, *cfg.patch_size, 1)).astype(np.float32)
    # a fresh jit per schedule: the JAX module reads the variable at trace time
    want = jax.device_get(jax.jit(lambda p, v: JaxRetinaUNet(cfg).apply(p, v))(params, x))

    model = bridged_model(params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want)
    for key in ("box_logits", "box_deltas", "seg_logits"):
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)


def test_bf16_forward_is_finite():
    cfg = torch_cfg(dtype="bfloat16")
    model = RetinaUNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.RandomState(1).standard_normal((1, 32, 32, 32, 1)))
    with torch.inference_mode():
        out = model(x.float())
    for v in out.values():
        assert v.dtype == torch.bfloat16
        assert torch.isfinite(v.float()).all()


def _head_outputs(seed, b=3, quantize=False):
    cfg = torch_cfg()
    anchors, _ = cfg.anchors()
    rng = np.random.RandomState(seed)
    logits = (rng.standard_normal((b, len(anchors), 1)) * 3).astype(np.float32)
    if quantize:  # many exact ties in the scores
        logits = np.round(logits)
    deltas = (rng.standard_normal((b, len(anchors), 6)) * 0.3).astype(np.float32)
    return cfg, anchors, logits, deltas


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kwargs", [{}, {"topk_candidates": 1000, "max_out": 100}])
def test_batched_postprocess_matches_jax(quantize, kwargs):
    cfg, anchors, logits, deltas = _head_outputs(7, quantize=quantize)
    want = jax.device_get(jax_batched_postprocess(
        jax_cfg(), {"box_logits": jnp.asarray(logits), "box_deltas": jnp.asarray(deltas)},
        jnp.asarray(anchors), cfg.patch_size, **kwargs))
    got = batched_postprocess(
        cfg, {"box_logits": torch.from_numpy(logits), "box_deltas": torch.from_numpy(deltas)},
        torch.from_numpy(anchors), cfg.patch_size, **kwargs)
    assert got["valid"].any()
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_array_equal(got["scores"].numpy(), want["scores"])
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-5)


def test_postprocess_single_image_matches_batch():
    cfg, anchors, logits, deltas = _head_outputs(8, b=2)
    batch = batched_postprocess(
        cfg, {"box_logits": torch.from_numpy(logits), "box_deltas": torch.from_numpy(deltas)},
        torch.from_numpy(anchors), cfg.patch_size)
    one = postprocess_detections(cfg, torch.from_numpy(logits[1]), torch.from_numpy(deltas[1]),
                                 torch.from_numpy(anchors), cfg.patch_size)
    for k in ("boxes", "scores", "labels", "valid"):
        np.testing.assert_array_equal(one[k].numpy(), batch[k][1].numpy())


def test_anchors_match_jax():
    a_t, per_t = torch_cfg().anchors()
    a_j, per_j = jax_cfg().anchors()
    np.testing.assert_array_equal(a_t, a_j)
    assert per_t == per_j
    a_t, _ = torch_cfg().anchors((24, 40, 16))
    a_j, _ = jax_cfg().anchors((24, 40, 16))
    np.testing.assert_array_equal(a_t, a_j)


def test_box_geometry_matches_jax():
    rng = np.random.RandomState(3)
    anchors = np.asarray(jax_cfg().anchors()[0][:500])
    deltas = (rng.standard_normal((500, 6)) * 2).astype(np.float32)
    deltas[:5, 2] = 50.0  # beyond the log-size clip
    want = np.asarray(JaxBoxCoder(dim=3).decode(jnp.asarray(deltas), jnp.asarray(anchors)))
    got = BoxCoder(dim=3).decode(torch.from_numpy(deltas), torch.from_numpy(anchors))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)

    clipped = tops.clip_boxes_to_image(got, (32, 24, 16))
    np.testing.assert_array_equal(
        clipped.numpy(), np.asarray(jops.clip_boxes_to_image(jnp.asarray(got.numpy()), (32, 24, 16))))
    np.testing.assert_array_equal(
        tops.small_boxes_mask(clipped, 2.0).numpy(),
        np.asarray(jops.small_boxes_mask(jnp.asarray(clipped.numpy()), 2.0)))
    b1, b2 = got[:40], got[100:170]
    np.testing.assert_allclose(
        tops.box_iou(b1, b2).numpy(),
        np.asarray(jops.box_iou(jnp.asarray(b1.numpy()), jnp.asarray(b2.numpy()))),
        rtol=1e-5, atol=1e-6)
    mins, maxs = tops.box_corners(got)
    np.testing.assert_array_equal(tops.boxes_from_corners(mins, maxs).numpy(), got.numpy())
