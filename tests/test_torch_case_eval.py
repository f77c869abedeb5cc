"""Case-level and directory-level evaluation of the PyTorch port against the
JAX package, and ``pipeline.predict_dir``: the NumPy AUROC and AP against
scikit-learn's (on the test side only; the port imports no scikit-learn),
``CaseEvaluator``, ``evaluate_box_dir``, ``evaluate_case_dir`` and
``evaluate_seg_dir`` on the same files, and the files ``predict_dir``
writes."""
import pickle

import numpy as np
import pytest
import torch
from sklearn.metrics import average_precision_score as sk_ap
from sklearn.metrics import roc_auc_score as sk_auroc

from nndetection_tpu import pipeline as j_pipeline
from nndetection_tpu.evaluator.case import CaseEvaluator as JaxCaseEvaluator
from nndetection_tpu.evaluator.registry import evaluate_box_dir as j_evaluate_box_dir
from nndetection_tpu.evaluator.registry import evaluate_case_dir as j_evaluate_case_dir
from nndetection_tpu.evaluator.registry import evaluate_seg_dir as j_evaluate_seg_dir
from nndetection_tpu.inference.predictor import ModelBundle as JaxBundle
from nndetection_tpu_torch import bridge, pipeline
from nndetection_tpu_torch.evaluator import froc
from nndetection_tpu_torch.evaluator.case import CaseEvaluator
from nndetection_tpu_torch.evaluator.registry import (
    evaluate_box_dir,
    evaluate_case_dir,
    evaluate_seg_dir,
)
from nndetection_tpu_torch.inference.predictor import ModelBundle
from nndetection_tpu_torch.models.retina_unet import RetinaUNet
from nndetection_tpu_torch.utils.io import save_pickle
from tests.test_torch_bridge import jax_cfg, torch_cfg
from tests.test_torch_nms import random_boxes
from tests.test_torch_predictor import CASE_TOL, spread_params

torch.set_num_threads(1)

SCORE_TOL = 1e-12
EVAL_TOL = 1e-9


@pytest.mark.parametrize("n,levels", [(2, None), (7, None), (60, None), (60, 3), (200, 5),
                                      (31, 1), (500, 12)])
@pytest.mark.parametrize("seed", range(3))
def test_auroc_and_ap_match_sklearn(n, levels, seed):
    rng = np.random.RandomState(seed * 1000 + n)
    y_true = rng.rand(n) < 0.4
    y_true[0], y_true[-1] = True, False  # both classes present
    y_score = rng.rand(n) if levels is None else rng.randint(0, levels, n) / max(levels, 1)
    assert abs(froc.roc_auc_score(y_true, y_score) - sk_auroc(y_true, y_score)) <= SCORE_TOL
    assert abs(froc.average_precision_score(y_true, y_score) - sk_ap(y_true, y_score)) <= SCORE_TOL


def _case_inputs(rng, n_cases, classes):
    cases = []
    for i in range(n_cases):
        n_pred = rng.randint(0, 6)
        n_gt = rng.randint(0, 3)
        cases.append(dict(pred_scores=np.round(rng.rand(n_pred), 1),  # ties between cases
                          pred_labels=rng.randint(0, classes, n_pred),
                          gt_classes=rng.randint(0, classes, n_gt)))
    return cases


@pytest.mark.parametrize("target_class", [None, 0, 1])
def test_case_evaluator_matches_jax(target_class):
    rng = np.random.RandomState(5)
    got, want = CaseEvaluator(["a", "b"], target_class), JaxCaseEvaluator(["a", "b"], target_class)
    for case in _case_inputs(rng, 30, 2):
        got.add_case(**case)
        want.add_case(**case)
    g, w = got.finish_online_evaluation(), want.finish_online_evaluation()
    assert set(g) == set(w) == {"case_auroc", "case_ap"}
    for k in g:
        assert abs(g[k] - w[k]) <= SCORE_TOL, k
    assert got.finish_online_evaluation() == want.finish_online_evaluation() == {}
    # one target class only: NaN on both sides
    for e in (got, want):
        e.add_case(np.asarray([0.5]), np.asarray([0]), np.asarray([0]))
    assert all(np.isnan(v) for v in got.finish_online_evaluation().values())


def write_dirs(tmp_path, n_cases=6, seed=6):
    """Seeded ``{cid}_boxes.pkl``, ``{cid}_seg.npz`` predictions and their
    ground truth."""
    rng = np.random.RandomState(seed)
    pred, gt = tmp_path / "pred", tmp_path / "gt"
    pred.mkdir()
    gt.mkdir()
    for i in range(n_cases):
        # no GT in the first case, some in the second: both case targets occur
        gt_boxes = random_boxes(rng, (0, 2)[i] if i < 2 else rng.randint(0, 4))
        boxes = np.concatenate([gt_boxes + rng.uniform(-3, 3, gt_boxes.shape),
                                random_boxes(rng, rng.randint(1, 8))]).astype(np.float32)
        save_pickle({"pred_boxes": boxes, "pred_scores": rng.rand(len(boxes)).astype(np.float32),
                     "pred_labels": rng.randint(0, 2, len(boxes))}, pred / f"case_{i}_boxes.pkl")
        np.savez(gt / f"case_{i}_boxes_gt.npz", boxes=gt_boxes,
                 classes=rng.randint(0, 2, len(gt_boxes)))
        seg_gt = (rng.rand(12, 10, 8) < 0.3).astype(np.int16)
        seg = np.where(rng.rand(*seg_gt.shape) < 0.8, seg_gt, 1 - seg_gt).astype(np.int16)
        np.savez_compressed(pred / f"case_{i}_seg.npz", seg=seg)
        np.savez_compressed(gt / f"case_{i}_seg_gt.npz", seg=seg_gt)
    return pred, gt


def test_evaluate_dirs_match_jax(tmp_path):
    pred, gt = write_dirs(tmp_path)
    out_port, out_jax = tmp_path / "port", tmp_path / "jax"
    for fast in (True, False):
        got, got_curves = evaluate_box_dir(pred, gt, ["a", "b"], save_dir=out_port, fast=fast)
        want, want_curves = j_evaluate_box_dir(pred, gt, ["a", "b"], save_dir=out_jax, fast=fast)
        assert set(got) == set(want) and len(got) >= 4
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=EVAL_TOL, err_msg=k)
        assert set(got_curves) == set(want_curves)
    assert sorted(p.name for p in out_port.iterdir()) == sorted(p.name for p in out_jax.iterdir())
    # the saved metrics beside the predictions are not read as a case
    again, _ = evaluate_box_dir(pred, gt, ["a", "b"], save_dir=pred)
    assert again == evaluate_box_dir(pred, gt, ["a", "b"])[0]

    for target in (None, 0, 1):
        got = evaluate_case_dir(pred, gt, ["a", "b"], target_class=target, save_dir=out_port)
        want = j_evaluate_case_dir(pred, gt, ["a", "b"], target_class=target, save_dir=out_jax)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=SCORE_TOL, err_msg=k)
        if target is None:
            assert all(np.isfinite(v) for v in got.values())
    got, want = evaluate_seg_dir(pred, gt, save_dir=out_port), j_evaluate_seg_dir(pred, gt)
    assert got == want and 0 < got["seg_dice_fg_mean"] < 1
    assert (out_port / "results_seg.json").exists() and (out_port / "results_case.json").exists()
    with pytest.raises(FileNotFoundError):
        evaluate_box_dir(tmp_path / "gt", gt, ["a"])


def write_cases(image_dir):
    """Two preprocessed cases: one smaller than the patch (padded), one with
    the properties that ``restore`` reads."""
    rng = np.random.RandomState(9)
    image_dir.mkdir()
    small = rng.standard_normal((2, 24, 40, 28)).astype(np.float32)  # data + seg channel
    np.save(image_dir / "case_a.npy", small)
    np.savez(image_dir / "case_a.npz", data=small)
    big = rng.standard_normal((2, 40, 36, 44)).astype(np.float32)
    np.savez(image_dir / "case_b.npz", data=big)
    props = {"transpose_forward": [2, 0, 1], "original_spacing": np.asarray([0.7, 0.8, 2.5]),
             "spacing_after_resampling": np.asarray([1.0, 1.2, 0.9]),
             "crop_bbox": [[3, 31], [5, 45], [0, 40]], "shape_after_crop": (28, 40, 40),
             "shape_before_crop": (34, 50, 46)}
    with open(image_dir / "case_b.pkl", "wb") as f:
        pickle.dump(props, f)


def test_predict_dir_matches_jax(tmp_path, monkeypatch):
    for name in ("NNDET_IN_STATS", "NNDET_INFER_TILE_FACTOR", "NNDET_INFER_BATCH_VOXELS"):
        monkeypatch.delenv(name, raising=False)
    image_dir = tmp_path / "images"
    write_cases(image_dir)
    params = spread_params(100.0)
    sd = bridge.state_dict_from_flax(params, RetinaUNet(torch_cfg()))
    kw = dict(tta=False, save_state=True, restore=True, predict_seg=True)
    out_port, out_jax = tmp_path / "port", tmp_path / "jax"
    pipeline.predict_dir([ModelBundle(cfg=torch_cfg(), params=sd, name="m")], image_dir,
                         out_port, device="cpu", **kw)
    j_pipeline.predict_dir([JaxBundle(cfg=jax_cfg(), params=params, name="m")], image_dir,
                           out_jax, **kw)
    names = sorted(p.name for p in out_port.iterdir())
    assert names == sorted(p.name for p in out_jax.iterdir())
    assert names == ["case_a_boxes.pkl", "case_a_boxes_state.pkl", "case_a_seg.npz",
                     "case_b_boxes.pkl", "case_b_boxes_state.pkl", "case_b_seg.npz"]
    for cid, shape in (("case_a", (24, 40, 28)), ("case_b", (34, 50, 46))):
        with open(out_port / f"{cid}_boxes.pkl", "rb") as f:
            got = pickle.load(f)
        with open(out_jax / f"{cid}_boxes.pkl", "rb") as f:
            want = pickle.load(f)
        assert sorted(got) == sorted(want) and got["restored"] == want["restored"] is True
        assert len(got["pred_scores"]) == len(want["pred_scores"]) > 0
        np.testing.assert_array_equal(got["pred_labels"], want["pred_labels"])
        np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=0, atol=CASE_TOL)
        np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], rtol=0, atol=CASE_TOL)
        with np.load(out_port / f"{cid}_seg.npz") as f, np.load(out_jax / f"{cid}_seg.npz") as g:
            assert f.files == g.files == ["seg"]
            assert f["seg"].shape == g["seg"].shape == shape and f["seg"].dtype == g["seg"].dtype
            assert (f["seg"] != g["seg"]).mean() <= 1e-3
        with open(out_port / f"{cid}_boxes_state.pkl", "rb") as f:
            got_state = pickle.load(f)
        with open(out_jax / f"{cid}_boxes_state.pkl", "rb") as f:
            assert sorted(got_state) == sorted(pickle.load(f))

    # resume skips the finished cases, and without it they are predicted again
    stamp = (out_port / "case_a_boxes.pkl").stat().st_mtime_ns
    pipeline.predict_dir([ModelBundle(cfg=torch_cfg(), params=sd, name="m")], image_dir,
                         out_port, device="cpu", resume=True, **kw)
    assert (out_port / "case_a_boxes.pkl").stat().st_mtime_ns == stamp
