"""Whole-case prediction of the PyTorch port against the JAX ``Predictor``
(tiny configuration, identical bridged parameters, float32), and the host
NumPy modules copied into the port against the JAX package's own functions:
patching, ``ops_np``, WBC, ``restore_detection``, the TTA flips and the
ensembler."""
import jax
import numpy as np
import pytest
import torch

from nndetection_tpu.core.boxes import ops_np as j_ops_np
from nndetection_tpu.core.boxes.wbc import batched_wbc_np as j_batched_wbc_np
from nndetection_tpu.data import patching as j_patching
from nndetection_tpu.inference import tta as j_tta
from nndetection_tpu.inference.ensembler import BoxEnsemblerSelective as JaxEnsembler
from nndetection_tpu.inference.predictor import ModelBundle as JaxBundle
from nndetection_tpu.inference.predictor import Predictor as JaxPredictor
from nndetection_tpu.inference.restore import restore_detection as j_restore_detection
from nndetection_tpu_torch import bridge
from nndetection_tpu_torch.core.boxes import ops_np
from nndetection_tpu_torch.core.boxes import wbc
from nndetection_tpu_torch.data import patching
from nndetection_tpu_torch.inference import tta
from nndetection_tpu_torch.inference.ensembler import BoxEnsemblerSelective
from nndetection_tpu_torch.inference.predictor import ModelBundle, Predictor
from nndetection_tpu_torch.inference.restore import restore_detection
from nndetection_tpu_torch.models.retina_unet import RetinaUNet
from tests.test_torch_nms import random_boxes
from tests.test_torch_bridge import jax_cfg, jax_params, torch_cfg

torch.set_num_threads(1)

# whole case at float32: forward differences of ~1e-6 pass through top-k,
# NMS, WBC weighting and averaging of boxes in case coordinates
CASE_TOL = 1e-4


def _sorted(result):
    order = np.argsort(-np.asarray(result["pred_scores"]), kind="stable")
    return {k: np.asarray(result[k])[order] for k in ("pred_boxes", "pred_scores", "pred_labels")}


def spread_params(scale: float):
    """The tiny model's JAX-initialized parameters with the classifier's
    output conv scaled by ``scale``.

    At initialization every score sits within ~1e-2 of the prior
    probability, so hundreds of candidates per tile have scores closer than
    the ~1e-7 by which the two packages' float32 forwards differ. Those pairs
    may swap order, and the greedy NMS and box clustering of 8 TTA streams
    turn a swap into a different kept box. A scale of 100 spreads the logits
    so that most top scores saturate to exactly 1.0 in both packages, where
    ties break by index the same way; a trained model separates its scores
    likewise.
    """
    params = jax.tree.map(lambda v: v, jax_params())
    out = params["params"]["classifier"]["out"]
    out["kernel"] = out["kernel"] * np.float32(scale)
    return params


@pytest.mark.parametrize("tta_on,scale", [(False, 1.0), (False, 100.0), (True, 100.0)])
def test_predict_case_matches_jax(monkeypatch, tta_on, scale):
    monkeypatch.delenv("NNDET_IN_STATS", raising=False)
    monkeypatch.delenv("NNDET_INFER_TILE_FACTOR", raising=False)
    monkeypatch.delenv("NNDET_INFER_BATCH_VOXELS", raising=False)
    params = spread_params(scale)
    case = np.random.RandomState(1).standard_normal((1, 48, 48, 48)).astype(np.float32)

    want = JaxPredictor([JaxBundle(cfg=jax_cfg(), params=params)], tta=tta_on).predict_case(case)
    model = RetinaUNet(torch_cfg())
    sd = bridge.state_dict_from_flax(params, model)
    predictor = Predictor([ModelBundle(cfg=torch_cfg(), params=sd)], tta=tta_on, device="cpu")
    got = predictor.predict_case(case)

    assert len(want["pred_scores"]) > 0
    assert len(got["pred_scores"]) == len(want["pred_scores"])
    got, want = _sorted(got), _sorted(want)
    np.testing.assert_array_equal(got["pred_labels"], want["pred_labels"])
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=0, atol=CASE_TOL)
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"], rtol=0, atol=CASE_TOL)


@pytest.mark.parametrize("ensembler", ["BoxEnsemblerWBC", "BoxEnsemblerFastest"])
def test_predict_case_with_wbc_ensemblers_matches_jax(monkeypatch, ensembler):
    """The classic WBC ensemblers through ``predict_case`` (8-flip TTA, the
    scaled classifier): the port's ensembler gets the predictor's device,
    here the CPU, so its WBC takes the host path as the JAX one does."""
    for name in ("NNDET_IN_STATS", "NNDET_INFER_TILE_FACTOR", "NNDET_INFER_BATCH_VOXELS"):
        monkeypatch.delenv(name, raising=False)
    params = spread_params(100.0)
    case = np.random.RandomState(1).standard_normal((1, 48, 48, 48)).astype(np.float32)
    want = JaxPredictor([JaxBundle(cfg=jax_cfg(), params=params)], tta=True,
                        ensembler=ensembler).predict_case(case)
    sd = bridge.state_dict_from_flax(params, RetinaUNet(torch_cfg()))
    predictor = Predictor([ModelBundle(cfg=torch_cfg(), params=sd)], tta=True,
                          ensembler=ensembler, device="cpu")
    got = predictor.predict_case(case)
    assert type(got["ensembler"]).__name__ == ensembler
    assert got["ensembler"].device == torch.device("cpu")
    assert len(want["pred_scores"]) > 0
    assert len(got["pred_scores"]) == len(want["pred_scores"])
    # without a model-level NMS many clusters share the saturated score 1.0,
    # so their order is a float32 tie-break: pair each detection with its
    # nearest one on the other side, one to one
    rows = [np.concatenate([r["pred_boxes"], r["pred_scores"][:, None],
                            r["pred_labels"][:, None] * 1e3], 1) for r in (got, want)]
    dist = np.abs(rows[0][:, None] - rows[1][None]).max(-1)
    nearest = dist.argmin(1)
    assert sorted(nearest.tolist()) == list(range(len(nearest)))
    assert dist[np.arange(len(nearest)), nearest].max() <= CASE_TOL


def test_small_case_is_padded_and_restored():
    """A case smaller than the patch is padded and its boxes shifted back."""
    model = RetinaUNet(torch_cfg(), generator=torch.Generator().manual_seed(0))
    predictor = Predictor([ModelBundle(cfg=torch_cfg(), params=model.state_dict())],
                          tta=False, device="cpu")
    case = np.random.RandomState(2).standard_normal((1, 20, 40, 32)).astype(np.float32)
    res = predictor.predict_case(case, properties={
        "transpose_forward": [0, 1, 2], "original_spacing": np.ones(3),
        "spacing_after_resampling": np.full(3, 2.0), "crop_bbox": [[1, 30], [0, 90], [2, 70]]},
        restore=True)
    assert res["pred_boxes"].shape[1] == 6 and len(res["pred_boxes"]) > 0
    assert np.isfinite(res["pred_boxes"]).all()


# ------------------------------------------------------- host copies
@pytest.mark.parametrize("case_shape,patch,overlap", [
    ((48, 48, 48), (32, 32, 32), 0.5),
    ((140, 320, 320), (96, 128, 128), 0.5),
    ((64, 448, 448), (96, 128, 128), 0.25),
    ((32, 32, 32), (32, 32, 32), 0.5),
])
def test_patching_matches_jax(case_shape, patch, overlap):
    np.testing.assert_array_equal(patching.compute_grid(case_shape, patch, overlap),
                                  j_patching.compute_grid(case_shape, patch, overlap))
    np.testing.assert_array_equal(patching.compute_grid(case_shape, patch, overlap, "fixed"),
                                  j_patching.compute_grid(case_shape, patch, overlap, "fixed"))
    data = np.ones((1, 20, 33, 7), np.float32)
    for a, b in zip(patching.pad_to_min_shape(data, patch), j_patching.pad_to_min_shape(data, patch)):
        np.testing.assert_array_equal(a, b)


def test_tile_weight_map_matches_jax():
    for patch in ((8, 12, 6), (32, 32, 32)):
        np.testing.assert_array_equal(patching.tile_weight_map(patch),
                                      j_patching.tile_weight_map(patch))
        np.testing.assert_array_equal(patching.tile_weight_map(patch, "constant"),
                                      j_patching.tile_weight_map(patch, "constant"))


def test_ops_np_matches_jax():
    rng = np.random.RandomState(3)
    b1, b2 = random_boxes(rng, 60), random_boxes(rng, 45)
    np.testing.assert_array_equal(ops_np.box_iou_np(b1, b2), j_ops_np.box_iou_np(b1, b2))
    np.testing.assert_array_equal(ops_np.box_area_np(b1), j_ops_np.box_area_np(b1))
    np.testing.assert_array_equal(ops_np.box_center_np(b1), j_ops_np.box_center_np(b1))
    np.testing.assert_array_equal(ops_np.clip_boxes_to_image_np(b1, (40, 50, 60)),
                                  j_ops_np.clip_boxes_to_image_np(b1, (40, 50, 60)))
    np.testing.assert_array_equal(ops_np.permute_boxes_np(b1, [2, 0, 1]),
                                  j_ops_np.permute_boxes_np(b1, [2, 0, 1]))
    np.testing.assert_array_equal(ops_np.box_axis_vector_np([1, 2, 3], 3),
                                  j_ops_np.box_axis_vector_np([1, 2, 3], 3))
    scores = rng.rand(60).astype(np.float32)
    labels = rng.randint(0, 3, 60)
    for thr in (0.1, 0.5):
        np.testing.assert_array_equal(ops_np.nms_np(b1, scores, thr),
                                      j_ops_np.nms_np(b1, scores, thr))
        np.testing.assert_array_equal(ops_np.batched_nms_np(b1, scores, labels, thr),
                                      j_ops_np.batched_nms_np(b1, scores, labels, thr))


def test_wbc_matches_jax():
    rng = np.random.RandomState(4)
    boxes = random_boxes(rng, 80)
    scores = rng.rand(80).astype(np.float32)
    labels = rng.randint(0, 2, 80)
    weights = rng.rand(80).astype(np.float32)
    n_exp = np.full(80, 3.0)
    for thr in (0.1, 0.5):
        got = wbc.batched_wbc_np(boxes, scores, labels, weights, n_exp, iou_thresh=thr)
        want = j_batched_wbc_np(boxes, scores, labels, weights, n_exp, iou_thresh=thr)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_restore_detection_matches_jax():
    boxes = random_boxes(np.random.RandomState(5), 20).astype(np.float64)
    kw = dict(transpose_forward=[2, 0, 1], original_spacing=[0.7, 0.8, 2.5],
              resampled_spacing=[1.0, 1.2, 0.9], crop_bbox=[[3, 90], [5, 100], [0, 40]])
    np.testing.assert_array_equal(restore_detection(boxes, **kw), j_restore_detection(boxes, **kw))
    assert restore_detection(np.zeros((0, 6)), **kw).shape == (0, 6)


def test_tta_matches_jax():
    assert tta.get_tta_flips(3) == j_tta.get_tta_flips(3)
    assert tta.get_tta_flips(3, False) == j_tta.get_tta_flips(3, False)
    boxes = random_boxes(np.random.RandomState(6), 30)
    img = np.random.RandomState(7).standard_normal((2, 4, 5, 6, 1)).astype(np.float32)
    for flips in j_tta.get_tta_flips(3):
        np.testing.assert_allclose(
            tta.invert_boxes(torch.from_numpy(boxes), flips, (32, 40, 48)).numpy(),
            j_tta.invert_boxes(boxes, flips, (32, 40, 48)), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tta.flip_image(torch.from_numpy(img), flips).numpy(),
                                      j_tta.flip_image(img, flips))


def test_ensembler_matches_jax():
    rng = np.random.RandomState(8)
    ens_t, ens_j = BoxEnsemblerSelective((64, 64, 64)), JaxEnsembler((64, 64, 64))
    for stream in ("m0_t()", "m0_t(0,)"):
        for ens in (ens_t, ens_j):
            ens.add_model(stream)
        for origin in ((0, 0, 0), (32, 0, 16)):
            boxes = random_boxes(rng, 25) * 0.35
            scores = rng.rand(25).astype(np.float32)
            labels = rng.randint(0, 2, 25)
            for ens in (ens_t, ens_j):
                ens.process_tile(boxes, scores, labels, origin, (32, 32, 32))
    got, want = ens_t.get_case_result(), ens_j.get_case_result()
    assert len(got["pred_scores"]) > 0
    for k in ("pred_boxes", "pred_scores", "pred_labels"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9, err_msg=k)
