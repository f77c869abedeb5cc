"""The PyTorch port's evaluator (``evaluator/``, NumPy copies) against the
JAX package's on random predictions and ground truth: matching, COCO AP,
FROC and the whole ``BoxEvaluator`` in both presets at rtol 1e-12, and the
port's NumPy ``roc_curve`` against scikit-learn's."""
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_curve as sk_roc_curve

from nndetection_tpu.evaluator import coco as j_coco
from nndetection_tpu.evaluator import det as j_det
from nndetection_tpu.evaluator import froc as j_froc
from nndetection_tpu.evaluator import matching as j_matching
from nndetection_tpu_torch.evaluator import coco, det, froc, matching
from tests.test_torch_nms import random_boxes

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=0)
CLASSES = ["nodule", "mass"]


def random_batch(seed, images=6):
    """Per image: GT boxes, and predictions that are jittered GT (hits at
    various IoU), clutter and missed GT, over two classes."""
    rng = np.random.RandomState(seed)
    batch = {k: [] for k in ("pred_boxes", "pred_scores", "pred_labels", "gt_boxes", "gt_classes")}
    for _ in range(images):
        n_gt = rng.randint(0, 5)
        gt = random_boxes(rng, n_gt).astype(np.float64)
        gt_cls = rng.randint(0, 2, n_gt)
        hit = rng.rand(n_gt) < 0.7
        jitter = rng.uniform(-4, 4, (int(hit.sum()), 6))
        clutter = random_boxes(rng, rng.randint(0, 8)).astype(np.float64)
        pb = np.concatenate([gt[hit] + jitter, clutter]) if n_gt or len(clutter) else np.zeros((0, 6))
        pl = np.concatenate([gt_cls[hit], rng.randint(0, 2, len(clutter))]).astype(np.int64)
        ps = rng.rand(len(pb))
        ps[: int(hit.sum())] = np.round(ps[: int(hit.sum())], 1)  # tied scores
        for k, v in zip(batch, (pb, ps, pl, gt, gt_cls)):
            batch[k].append(v)
    return batch


def assert_dicts_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   **TOL, err_msg=k)


def test_matching_batch_matches_jax():
    b = random_batch(0, images=10)
    ious = (0.1, 0.3, 0.5)
    got = matching.matching_batch(ious, b["pred_boxes"], b["pred_labels"], b["pred_scores"],
                                  b["gt_boxes"], b["gt_classes"], max_detections=5)
    want = j_matching.matching_batch(ious, b["pred_boxes"], b["pred_labels"], b["pred_scores"],
                                     b["gt_boxes"], b["gt_classes"], max_detections=5)
    assert len(got) == len(want)
    matched = 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for c in w:
            assert_dicts_close(g[c], w[c])
            matched += int(np.sum(w[c]["dtMatches"]))
    assert matched > 0


def _results(seed, ious):
    b = random_batch(seed, images=12)
    return j_matching.matching_batch(ious, b["pred_boxes"], b["pred_labels"], b["pred_scores"],
                                     b["gt_boxes"], b["gt_classes"])


def test_coco_metric_matches_jax():
    kw = dict(iou_list=(0.1, 0.5), iou_range=(0.1, 0.5, 0.05), max_detection=(1, 5, 100))
    got_m, want_m = coco.COCOMetric(CLASSES, **kw), j_coco.COCOMetric(CLASSES, **kw)
    results = _results(1, want_m.get_iou_thresholds())
    got, _ = got_m.compute(results)
    want, _ = want_m.compute(results)
    assert_dicts_close(got, want)
    assert want["mAP_IoU_0.10_0.50_0.05_MaxDet_100"] > 0


@pytest.mark.parametrize("per_class", [False, True])
def test_froc_metric_matches_jax(per_class):
    got_m, want_m = froc.FROCMetric(CLASSES, per_class=per_class), j_froc.FROCMetric(CLASSES, per_class=per_class)
    results = _results(2, want_m.get_iou_thresholds())
    got_s, got_c = got_m.compute(results)
    want_s, want_c = want_m.compute(results)
    assert_dicts_close(got_s, want_s)
    assert_dicts_close(got_c, want_c)


@pytest.mark.parametrize("fast", [True, False])
def test_box_evaluator_matches_jax(fast):
    got_e, want_e = det.BoxEvaluator.create(CLASSES, fast=fast), j_det.BoxEvaluator.create(CLASSES, fast=fast)
    for seed in (3, 4):
        b = random_batch(seed)
        got_e.add_batch(**b)
        want_e.add_batch(**b)
    got_s, got_c = got_e.finish_online_evaluation()
    want_s, want_c = want_e.finish_online_evaluation()
    assert_dicts_close(got_s, want_s)
    assert_dicts_close(got_c, want_c)
    assert got_e.results_list == []


def test_box_evaluator_padded_inputs():
    """Fixed-size arrays with validity masks give what the ragged arrays give."""
    b = random_batch(5, images=3)
    pad = 10
    padded = {k: [] for k in ("pred_boxes", "pred_scores", "pred_labels", "pred_valid")}
    for pb, ps, pl in zip(b["pred_boxes"], b["pred_scores"], b["pred_labels"]):
        n = len(ps)
        padded["pred_boxes"].append(np.concatenate([pb, np.zeros((pad - n, 6))]))
        padded["pred_scores"].append(np.concatenate([ps, np.zeros(pad - n)]))
        padded["pred_labels"].append(np.concatenate([pl, np.zeros(pad - n, np.int64)]))
        padded["pred_valid"].append(np.arange(pad) < n)
    runs = []
    for inputs in (b, dict(padded, gt_boxes=b["gt_boxes"], gt_classes=b["gt_classes"])):
        e = det.BoxEvaluator.create(CLASSES)
        e.add_batch(**inputs)
        runs.append(e.finish_online_evaluation()[0])
    assert runs[0] == runs[1]


def test_segmentation_evaluator_matches_jax():
    rng = np.random.RandomState(6)
    got_e, want_e = det.SegmentationEvaluator(), j_det.SegmentationEvaluator()
    for _ in range(3):
        pred, gt = rng.rand(8, 8, 8) > 0.5, rng.rand(8, 8, 8) > 0.6
        got_e.add_batch(pred, gt)
        want_e.add_batch(pred, gt)
    assert got_e.finish_online_evaluation() == want_e.finish_online_evaluation()


@pytest.mark.parametrize("n,levels", [(3, 0), (50, 0), (200, 10), (500, 3)])
@pytest.mark.parametrize("drop_intermediate", [True, False])
def test_roc_curve_matches_sklearn(n, levels, drop_intermediate):
    rng = np.random.RandomState(n + levels)
    y_true = (rng.rand(n) < 0.4).astype(np.float64)
    y_true[:2] = [0.0, 1.0]
    y_score = rng.rand(n) if not levels else rng.randint(0, levels, n) / levels
    got = froc.roc_curve(y_true, y_score, drop_intermediate=drop_intermediate)
    want = sk_roc_curve(y_true, y_score, drop_intermediate=drop_intermediate)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
