"""The 2D RetinaUNet of the PyTorch port against the JAX package on the
configuration of ``tests/test_2d.py``: the forward at float32 and bfloat16
with the same flax parameters through the bridge, the detection
post-processing, the greedy NMS and the weighted box clustering on 2D boxes
(lifted to unit depth in front of the kernels' plain versions), the train-step
losses and their gradients with the JAX sampler draws injected, whole-case
prediction with the four 2D flips, and the drivers from ``run_prep`` to
``run_evaluate`` on a raw 2D task, the plan equal to the JAX package's under
injected probe verdicts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu import pipeline as jpipeline
from nndetection_tpu.core.boxes import ops as jops
from nndetection_tpu.core.boxes.nms import batched_nms_mask as j_batched_nms_mask
from nndetection_tpu.core.boxes.nms import batched_nms_topk as j_batched_nms_topk
from nndetection_tpu.core.boxes.nms import topk_nms as j_topk_nms
from nndetection_tpu.core.boxes.wbc import batched_wbc as j_batched_wbc
from nndetection_tpu.data.example import generate_example_dataset as j_generate
from nndetection_tpu.data.gt_prep import prepare_targets as j_prepare_targets
from nndetection_tpu.inference.ensembler import BoxEnsemblerSelective as JaxEnsembler
from nndetection_tpu.inference.predictor import ModelBundle as JaxBundle
from nndetection_tpu.inference.predictor import Predictor as JaxPredictor
from nndetection_tpu.models import RetinaUNet as JaxRetinaUNet
from nndetection_tpu.models import batched_postprocess as j_batched_postprocess
from nndetection_tpu.models.retina_unet import train_step_loss as j_train_step_loss
from nndetection_tpu.planning import estimator as jest
from nndetection_tpu.planning import planner as jplanner
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch import pipeline as tpipeline
from nndetection_tpu_torch.core.boxes.nms import batched_nms_mask, batched_nms_topk, topk_nms
from nndetection_tpu_torch.core.boxes.wbc import batched_wbc
from nndetection_tpu_torch.data.example import generate_example_dataset
from nndetection_tpu_torch.data.gt_prep import prepare_targets
from nndetection_tpu_torch.inference.ensembler import BoxEnsemblerSelective
from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
from nndetection_tpu_torch.models.retina_unet import (
    RetinaUNet,
    RetinaUNetConfig,
    batched_postprocess,
    train_step_loss,
)
from nndetection_tpu_torch.ops import lift_2d
from nndetection_tpu_torch.ops.iou_matrix import iou_matrix_plain
from nndetection_tpu_torch.ops.nms import nms_topk, nms_topk_plain
from nndetection_tpu_torch.planning import planner as tplanner
from nndetection_tpu_torch.planning.planner import Planner
from tests.test_2d import cfg_2d
from tests.test_torch_planning import same_plan
from tests.test_torch_train_loss import inject_draws, jax_draws, numpy_params, pool_cap

torch.set_num_threads(1)

FWD_TOL = 1e-4  # float32, as the 3D forward
BF16_TOL = 2e-2  # times max|out| of each output: bf16 convolutions summed in other orders
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
GRAD_TOL = 1e-3  # times max|g| of each tensor
CASE_TOL = 1e-4
WBC_TOL = dict(rtol=1e-5, atol=1e-6)  # float32 sums in other orders, as in 3D
LOSS_KEYS = ("cls", "reg", "seg_ce", "seg_dice", "num_pos", "num_neg")
# the 2D configuration of tests/test_2d.py as keyword overrides
CFG_2D = {f.name: getattr(cfg_2d(), f.name) for f in dataclasses.fields(cfg_2d())}


def jax_cfg(**overrides):
    return dataclasses.replace(cfg_2d(), **overrides)


def torch_cfg(**overrides):
    return RetinaUNetConfig(**{**CFG_2D, **overrides})


def t(a):
    return torch.from_numpy(np.array(a))


def jax_params(seed=0, **overrides):
    cfg = jax_cfg(**overrides)
    x = np.zeros((1, *cfg.patch_size, 1), np.float32)
    return jax.device_get(jax.jit(JaxRetinaUNet(cfg).init)(jax.random.PRNGKey(seed), x))


def bridged(params, **overrides):
    model = RetinaUNet(torch_cfg(**overrides))
    model.load_state_dict(bridge.state_dict_from_flax(params, model))
    return model.eval()


def boxes_2d(rng, n, lo=4.0, hi=90.0, size=(2.0, 25.0)):
    ctr = rng.uniform(lo, hi, (n, 2))
    half = rng.uniform(*size, (n, 2)) / 2
    return np.concatenate([ctr - half, ctr + half], axis=1).astype(np.float32)


# ------------------------------------------------------------------- forward
@pytest.mark.parametrize("dtype,tol", [("float32", FWD_TOL), ("bfloat16", BF16_TOL)])
def test_forward_matches_jax(monkeypatch, dtype, tol):
    monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    params = jax_params()
    x = np.random.RandomState(0).standard_normal((2, 32, 32, 1)).astype(np.float32)
    cfg = jax_cfg(dtype=dtype)
    want = jax.device_get(jax.jit(lambda p, v: JaxRetinaUNet(cfg).apply(p, v))(params, x))
    with torch.inference_mode():
        got = bridged(params, dtype=dtype)(t(x))
    assert set(got) == set(want) == {"box_logits", "box_deltas", "seg_logits"}
    assert got["box_deltas"].shape[-1] == 4 and got["seg_logits"].shape == (2, 32, 32, 2)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[k].float().numpy()
        assert g.shape == w.shape, k
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * float(np.abs(w).max()),
                                       err_msg=k)


# ------------------------------------------------------------ post-processing
@pytest.mark.parametrize("quantize", [False, True])
def test_batched_postprocess_matches_jax(quantize):
    cfg = torch_cfg()
    anchors, _ = cfg.anchors()
    rng = np.random.RandomState(7)
    logits = (rng.standard_normal((3, len(anchors), 1)) * 3).astype(np.float32)
    if quantize:  # many exact ties in the scores
        logits = np.round(logits)
    deltas = (rng.standard_normal((3, len(anchors), 4)) * 0.3).astype(np.float32)
    want = jax.device_get(j_batched_postprocess(
        jax_cfg(), {"box_logits": jnp.asarray(logits), "box_deltas": jnp.asarray(deltas)},
        jnp.asarray(anchors), cfg.patch_size))
    got = batched_postprocess(cfg, {"box_logits": t(logits), "box_deltas": t(deltas)},
                              t(anchors), cfg.patch_size)
    assert got["boxes"].shape == (3, 10, 4) and got["valid"].any()
    for k in ("valid", "labels", "scores"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-5)


# ---------------------------------------------------------------- NMS and WBC
def nms_inputs(seed, n, ties=False, degenerate=False):
    rng = np.random.RandomState(seed)
    boxes = boxes_2d(rng, n)
    scores = rng.rand(n).astype(np.float32)
    if ties:
        scores = np.floor(scores * 5) / 5
    if degenerate:  # zero-width, zero-area, repeated and nested boxes
        boxes[:4, 2] = boxes[:4, 0]
        boxes[4:6, 2:] = boxes[4:6, :2]
        boxes[6:10] = boxes[10]
        boxes[11] = boxes[12] + np.asarray([1, 1, -1, -1], np.float32)
    valid = rng.rand(n) > 0.1
    labels = rng.randint(0, 3, n).astype(np.int32)
    return boxes, scores, valid, labels


@pytest.mark.parametrize("n,max_out,ties,degenerate", [
    (1, 3, False, False), (40, 40, False, False), (300, 100, True, False),
    (300, 400, False, True), (1000, 100, True, True),
])
def test_lifted_nms_matches_jax(n, max_out, ties, degenerate):
    """``topk_nms`` and ``batched_nms_topk`` on 2D boxes (the plain version on
    lifted boxes) against the JAX ``lax`` NMS on the 2D boxes: the same
    indices and flags."""
    boxes, scores, valid, labels = nms_inputs(n + max_out, n, ties, degenerate)
    for thr in (0.0, 0.3, 0.6):
        wi, wv = j_topk_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr,
                            max_out)
        gi, gv = topk_nms(t(boxes)[None], t(scores)[None], t(valid)[None], thr, max_out)
        np.testing.assert_array_equal(gv[0].numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi[0].numpy(), np.asarray(wi))
        wi, wv = j_batched_nms_topk(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                                    jnp.asarray(valid), thr, max_out)
        gi, gv = batched_nms_topk(t(boxes)[None], t(scores)[None], t(labels)[None],
                                  t(valid)[None], thr, max_out)
        np.testing.assert_array_equal(gv[0].numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi[0].numpy(), np.asarray(wi))
        assert gv.any() or not valid.any()


@pytest.mark.parametrize("ties,degenerate", [(False, False), (True, True)])
def test_lifted_nms_mask_matches_jax(ties, degenerate):
    """The untruncated class-batched NMS on 2D boxes (the suppression words
    and the keep-scan on lifted boxes) against the JAX ``batched_nms_mask``."""
    boxes, scores, valid, labels = nms_inputs(9, 300, ties, degenerate)
    for thr in (0.0, 0.4):
        want = j_batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                                  jnp.asarray(valid), thr)
        got = batched_nms_mask(t(boxes), t(scores), t(labels), t(valid), thr)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any()


def test_lift_keeps_the_2d_iou_bits():
    """The kernels' IoU of lifted boxes equals the JAX 2D ``box_iou`` bit for
    bit wherever the union is positive; where it is zero the JAX IoU is NaN
    and the kernels' is 0, above no threshold either way."""
    boxes, _, _, _ = nms_inputs(3, 200, degenerate=True)
    lifted = lift_2d(t(boxes))
    assert lifted.shape == (200, 6)
    np.testing.assert_array_equal(lifted[:, 4:].numpy(), np.tile([0.0, 1.0], (200, 1)))
    got = iou_matrix_plain(lifted, lifted).numpy()
    want = np.asarray(jops.box_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    finite = np.isfinite(want)
    assert (~finite).any() and finite.sum() > 30000
    np.testing.assert_array_equal(got[finite], want[finite])
    assert (got[~finite] == 0).all()
    np.testing.assert_array_equal(lift_2d(lifted), lifted)


def test_nms_kernel_wrapper_lifts_2d_boxes():
    boxes, scores, valid, _ = nms_inputs(5, 100, ties=True)
    masked = t(np.where(valid, scores, -np.inf).astype(np.float32))[None]
    gi, gv = nms_topk(t(boxes)[None], masked, 0.4, 30)
    pi, pv = nms_topk_plain(lift_2d(t(boxes))[None], masked, 0.4, 30)
    assert torch.equal(gi, pi.long()) and torch.equal(gv, pv)


def wbc_inputs_2d(seed, n, classes):
    rng = np.random.RandomState(seed)
    centers = boxes_2d(rng, max(n // 6, 1))
    boxes = centers[rng.randint(0, len(centers), n)] + rng.uniform(-2, 2, (n, 4)).astype(np.float32)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
    scores = rng.rand(n).astype(np.float32)
    scores[: n // 10] = 0.5  # ties
    labels = rng.randint(0, classes, n).astype(np.int32)
    weights = (0.5 + rng.rand(n)).astype(np.float32)
    n_exp = rng.randint(1, 9, n).astype(np.float32)
    valid = rng.rand(n) > 0.05
    return boxes, scores, labels, weights, n_exp, valid


@pytest.mark.parametrize("n,classes,use_area", [(60, 1, False), (200, 2, True)])
def test_lifted_wbc_matches_jax(n, classes, use_area):
    """``batched_wbc`` on 2D boxes (the cluster kernel's plain version on
    lifted boxes, z sliced off) against the JAX package's device WBC on the
    2D boxes: the same clusters, labels and flags; boxes and scores within
    the 3D test's float32 tolerance (the two sum each cluster in other
    orders)."""
    arrays = wbc_inputs_2d(n + classes, n, classes)
    for iou_thresh in (0.2, 0.5):
        kw = dict(iou_thresh=iou_thresh, score_thresh=0.1, use_area=use_area,
                  missing_weight=0.5, num_classes=classes)
        got = batched_wbc(*map(t, arrays), **kw)
        want = jax.jit(lambda *a: j_batched_wbc(*a, **kw))(*map(jnp.asarray, arrays))
        gb, gs, gl, gv = (v.numpy() for v in got)
        wb, ws, wl, wv = (np.asarray(v) for v in want)
        assert gb.shape == (classes * n, 4) and gv.sum() > classes
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gs, ws, **WBC_TOL)
        np.testing.assert_allclose(gb, wb, **WBC_TOL)


def test_selective_ensembler_takes_empty_2d_tiles():
    """A tile without boxes enters a 2D case as ``[0, 4]``. The JAX
    package's ensembler files it as ``[0, 6]`` and fails to join it with the
    stream's 2D boxes (``ROADMAP.md`` queue 3)."""
    def feed(ens):
        ens.add_model("m")
        ens.process_tile(np.zeros((0, 4), np.float32), np.zeros(0), np.zeros(0), (0, 0),
                         (32, 32))
        ens.process_tile(np.asarray([[2, 2, 12, 14]], np.float32), np.asarray([0.9]),
                         np.asarray([0]), (8, 8), (32, 32))
        return ens

    res = feed(BoxEnsemblerSelective((40, 40), device="cpu")).get_case_result()
    np.testing.assert_allclose(res["pred_boxes"], [[10, 10, 20, 22]])
    empty = BoxEnsemblerSelective((40, 40), device="cpu").get_case_result()
    assert empty["pred_boxes"].shape == (0, 4)
    with pytest.raises(ValueError, match="size 6"):
        feed(JaxEnsembler((40, 40))).get_case_result()


# ---------------------------------------------------------------- train step
def batch_2d(seed=0, b=2, patch=(32, 32)):
    """Images and instance segmentations of a few rectangles, as NumPy."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, *patch), np.int32)
    table = np.full((b, 4), -1, np.int32)
    for i in range(b):
        for iid in range(1, 3 if i else 2):
            lo = rng.randint(2, 20, 2)
            ext = rng.randint(4, 11, 2)
            seg[i, lo[0]:lo[0] + ext[0], lo[1]:lo[1] + ext[1]] = iid
            table[i, iid - 1] = 0
    images = rng.standard_normal((b, *patch, 1)).astype(np.float32)
    return images, seg, table


@pytest.mark.parametrize("head", ["hnm", "no_sampler"])
def test_train_step_loss_and_gradients_match_jax(monkeypatch, head):
    """The tiny 2D model with the same NumPy-made flax parameters on both
    sides: the losses of ``train_step_loss`` (the JAX draws injected for the
    hard-negative head) and the gradient of their sum for every parameter."""
    monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    cfg = jax_cfg(head_type=head, exact_topk=True)
    params = numpy_params(0, **{**CFG_2D, "head_type": head})
    images, seg, table = batch_2d(1)
    targets = jax.device_get(j_prepare_targets(jnp.asarray(images), jnp.asarray(seg),
                                               jnp.asarray(table)))
    got_targets = prepare_targets(t(images), t(seg), t(table))
    for k, v in targets.items():
        np.testing.assert_array_equal(got_targets[k].numpy(), np.asarray(v), err_msg=k)
    anchors, per_level = cfg.anchors()
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        preds = JaxRetinaUNet(cfg).apply(p, targets["images"])
        out = j_train_step_loss(cfg, preds, jnp.asarray(anchors), per_level,
                                {k: jnp.asarray(v) for k, v in targets.items()}, key)
        return out["cls"] + out["reg"] + out["seg_ce"] + out["seg_dice"], out

    (_, want), want_grads = jax.device_get(
        jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params))

    model = RetinaUNet(torch_cfg(head_type=head))
    model.load_state_dict(bridge.state_dict_from_flax(params, model))
    if head != "no_sampler":
        inject_draws(monkeypatch, jax_draws(key, 2, len(anchors), pool_cap(cfg)))
    got = train_step_loss(model.cfg, model(t(targets["images"])), t(anchors), per_level,
                          got_targets, torch.Generator())
    assert want["num_pos"] > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    (got["cls"] + got["reg"] + got["seg_ce"] + got["seg_dice"]).backward()
    grads = bridge.state_dict_from_flax(want_grads, model)
    for name, p in model.named_parameters():
        w = grads[name]
        torch.testing.assert_close(p.grad, w, rtol=0, atol=GRAD_TOL * float(w.abs().max()),
                                   msg=name)


# ------------------------------------------------------------------ predictor
def test_predict_case_with_four_flips_matches_jax(monkeypatch):
    for name in ("NNDET_IN_STATS", "NNDET_INFER_TILE_FACTOR", "NNDET_INFER_BATCH_VOXELS"):
        monkeypatch.delenv(name, raising=False)
    params = jax_params()
    # spread the scores (tests/test_torch_predictor.py::spread_params)
    out = params["params"]["classifier"]["out"]
    out["kernel"] = out["kernel"] * np.float32(100.0)
    case = np.random.RandomState(1).standard_normal((1, 56, 44)).astype(np.float32)
    jp = JaxPredictor([JaxBundle(cfg=jax_cfg(), params=params)], tta=True)
    want = jp.predict_case(case)
    sd = bridge.state_dict_from_flax(params, RetinaUNet(torch_cfg()))
    tp = Predictor([ModelBundle(cfg=torch_cfg(), params=sd)], tta=True, device="cpu")
    assert tp.tta_flips == jp.tta_flips == [(), (0,), (1,), (0, 1)]
    got = tp.predict_case(case)
    assert len(want["pred_scores"]) > 0
    assert len(got["pred_scores"]) == len(want["pred_scores"])
    order_g = np.argsort(-got["pred_scores"], kind="stable")
    order_w = np.argsort(-want["pred_scores"], kind="stable")
    np.testing.assert_array_equal(got["pred_labels"][order_g], want["pred_labels"][order_w])
    np.testing.assert_allclose(got["pred_scores"][order_g], want["pred_scores"][order_w],
                               rtol=0, atol=CASE_TOL)
    np.testing.assert_allclose(got["pred_boxes"][order_g], want["pred_boxes"][order_w],
                               rtol=0, atol=CASE_TOL)
    assert got["pred_boxes"].shape[1] == 4


# ------------------------------------------------------------------ pipeline
GIB = 1024 ** 3


def test_pipeline_from_raw_images_to_scores(monkeypatch, tmp_path):
    """``run_prep`` of both packages on two copies of one seeded raw 2D task,
    the probe's verdicts injected into both planners (the batch halved once):
    the same ``Plan`` field by field. Then the port's drivers take it to
    scores on the CPU: ``run_train``, ``run_sweep``, ``run_consolidate``,
    ``run_predict_test`` with the four flips and ``run_evaluate``."""
    def probe(cfg, batch_size, max_instances=32, **kw):
        assert cfg.dim == 2
        return jest.MemoryEstimate(batch_size * GIB, {})

    monkeypatch.setattr(jplanner, "probe_train_step_estimate", probe)
    monkeypatch.setattr(tplanner, "probe_train_step_estimate", probe)
    kw = dict(num_train=4, num_test=1, image_size=(48, 48), object_size=(8, 14),
              object_width=2, spacing=(0.7, 0.7))
    got_task = generate_example_dataset(tmp_path / "t" / "Task001D2_Example2D", **kw)
    want_task = j_generate(tmp_path / "j" / "Task001D2_Example2D", **kw)
    budget = 10 * GIB
    plan = tpipeline.run_prep(got_task, planner=Planner(
        hbm_budget=budget, anchor_budget=50, device="cpu", compile_validate=True), device="cpu")
    want = jpipeline.run_prep(want_task, planner=jplanner.Planner(
        hbm_budget=budget, anchor_budget=50, compile_validate=True))
    same_plan(plan, want)
    assert plan.dim == 2 and len(plan.patch_size) == 2 and "depth" not in plan.anchors
    assert plan.mem_compiled_bytes == plan.batch_size * GIB > 0

    model_dir = tmp_path / "models" / "M"
    tpipeline.run_train(
        got_task, model_dir, fold=0, device="cpu",
        model_overrides=dict(start_channels=8, fpn_channels=16, head_channels=16,
                             dtype="float32"),
        trainer_overrides=dict(max_epochs=1, num_train_batches_per_epoch=3,
                               num_val_batches_per_epoch=1, warm_iterations=2, swa_epochs=0,
                               batch_size=2))
    assert (model_dir / "fold0" / "model_last.ckpt").exists()
    tpipeline.run_sweep(got_task, model_dir, 0, device="cpu")
    tpipeline.run_consolidate(got_task, model_dir, num_folds=1, device="cpu")
    pred_dir = tpipeline.run_predict_test(got_task, model_dir, device="cpu")
    preds = sorted(pred_dir.glob("*_boxes.pkl"))
    assert preds
    from nndetection_tpu_torch.utils.io import load_pickle

    assert load_pickle(preds[0])["pred_boxes"].shape[1] == 4
    metrics, _ = tpipeline.run_evaluate(got_task, pred_dir, split="Ts", device="cpu")
    key = "mAP_IoU_0.10_0.50_0.05_MaxDet_100"
    assert key in metrics and np.isfinite(metrics[key])
