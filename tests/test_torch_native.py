"""The port's host library (``nndetection_tpu_torch/csrc/nndet_host.cpp``,
bound by ``ops/native.py``): its build, and its greedy loops against the
port's NumPy loops (bit for bit) and against the JAX package's host
functions.

The JAX side's ``nms_np``, ``wbc_np`` and matching call the JAX package's own
native library when it is built, and its NumPy loops otherwise: the
comparisons below hold in either case."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from nndetection_tpu.core.boxes.ops_np import batched_nms_np as j_batched_nms_np
from nndetection_tpu.core.boxes.ops_np import nms_np as j_nms_np
from nndetection_tpu.core.boxes.wbc import wbc_np as j_wbc_np
from nndetection_tpu.evaluator.matching import matching_batch as j_matching_batch
from nndetection_tpu_torch.core.boxes import ops_np
from nndetection_tpu_torch.core.boxes.wbc import batched_wbc_np, wbc_np, wbc_np_plain
from nndetection_tpu_torch.evaluator import matching
from nndetection_tpu_torch.ops import _build, native
from tests.test_torch_nms import random_boxes

ROOT = Path(__file__).resolve().parents[1]
WBC_RTOL = 1e-12


def grid_boxes(rng, n, extent=6, zero_volume=0):
    """Boxes on a small integer grid: many pairs share an IoU exactly, and
    ``zero_volume`` of them are flat along x."""
    lo = rng.randint(0, extent, (n, 3)).astype(np.float64)
    hi = lo + rng.randint(1, extent, (n, 3))
    hi[:zero_volume, 0] = lo[:zero_volume, 0]
    return np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1)


def test_library_builds_in_the_package_and_never_in_root_csrc(tmp_path, monkeypatch):
    """The default library lies under the package's ``_build/``; a build
    runs one compiler call on the package's own source, no ``make``, and
    writes only into its build directory."""
    assert native.available()
    assert _build.host_library_path().parent == ROOT / "nndetection_tpu_torch" / "_build"
    assert _build.HOST_SOURCE == ROOT / "nndetection_tpu_torch" / "csrc" / "nndet_host.cpp"
    assert _build.host_library_path().exists()
    calls = []
    run = subprocess.run
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kw: calls.append(cmd) or run(cmd, **kw))
    out = _build.build_host(tmp_path)
    assert len(calls) == 1 and calls[0][0] == _build.host_compiler()
    assert "make" not in calls[0]
    assert str(_build.HOST_SOURCE) in calls[0]
    assert not any(str(ROOT / "csrc") in str(a) for a in calls[0])
    assert "-ffp-contract=off" in calls[0] and "-march=native" not in calls[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == [out.name]
    # a current library is reused, not rebuilt
    assert _build.build_host(tmp_path) == out and len(calls) == 1


def test_six_processes_building_at_once_leave_one_library(tmp_path):
    code = textwrap.dedent(f"""
        import ctypes, sys
        sys.path.insert(0, {str(ROOT)!r})
        from nndetection_tpu_torch.ops import _build
        path = _build.build_host({str(tmp_path)!r})
        ctypes.CDLL(str(path)).nms_3d
        print(path)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.iterdir()] == [Path(paths.pop()).name]


def test_compile_error_raises(tmp_path, monkeypatch):
    bad = tmp_path / "nndet_host.cpp"
    bad.write_text("extern \"C\" int nms_3d( {")
    monkeypatch.setattr(_build, "HOST_SOURCE", bad)
    with pytest.raises(RuntimeError, match="host library build failed"):
        _build.build_host(tmp_path / "build")


def test_without_a_compiler_the_numpy_loops_run(monkeypatch):
    """No compiler on ``PATH``: the entry points return ``None`` and the
    callers run their NumPy loops; the library is not called."""
    monkeypatch.setattr(_build, "host_compiler", lambda: None)
    monkeypatch.setattr(_build, "host_library_path", lambda build_dir=None: Path("/nonexistent.so"))
    monkeypatch.setattr(_build, "_host_lib", None)
    monkeypatch.setattr(native, "_bound", None)
    native.NATIVE_CALLS.clear()
    rng = np.random.RandomState(0)
    boxes, scores = random_boxes(rng, 50), rng.rand(50)
    assert native.nms_native(boxes, scores, 0.3) is None
    np.testing.assert_array_equal(ops_np.nms_np(boxes, scores, 0.3),
                                  ops_np.nms_np_plain(boxes, scores, 0.3))
    b, s = wbc_np(boxes, scores, np.ones(50), np.ones(50), 0.3)
    assert len(s) > 0
    assert sum(native.NATIVE_CALLS.values()) == 0


# ------------------------------------------------------------------ NMS
def test_iou_matrix_equals_numpy_bit_for_bit():
    rng = np.random.RandomState(70)
    a, b = grid_boxes(rng, 40), random_boxes(rng, 30).astype(np.float64)
    native.NATIVE_CALLS.clear()
    np.testing.assert_array_equal(native.iou_matrix_native(a, b), ops_np.box_iou_np(a, b))
    np.testing.assert_array_equal(native.iou_matrix_native(b, b), ops_np.box_iou_np(b, b))
    assert native.NATIVE_CALLS["iou_matrix_3d"] == 2


@pytest.mark.parametrize("seed", range(4))
def test_nms_equals_numpy_bit_for_bit(seed):
    """Integer-grid boxes (IoUs shared exactly by many pairs), scores in four
    levels (ties), a few zero-volume boxes, and thresholds equal to IoUs that
    occur: the keep lists are identical."""
    rng = np.random.RandomState(seed)
    boxes = grid_boxes(rng, 120, zero_volume=6)
    scores = rng.randint(0, 4, 120) / 4.0
    with np.errstate(invalid="ignore"):
        ious = np.unique(ops_np.box_iou_np(boxes, boxes))
    ious = ious[np.isfinite(ious) & (ious > 0) & (ious < 1)]
    native.NATIVE_CALLS.clear()
    thresholds = [0.0, 0.5] + list(rng.choice(ious, 6, replace=False))
    with np.errstate(invalid="ignore"):
        for thr in thresholds:
            got = ops_np.nms_np(boxes, scores, thr)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, ops_np.nms_np_plain(boxes, scores, thr))
    assert native.NATIVE_CALLS["nms_3d"] == len(thresholds)


@pytest.mark.parametrize("seed", range(3))
def test_batched_nms_equals_numpy_with_class_offsets(seed):
    rng = np.random.RandomState(10 + seed)
    boxes = grid_boxes(rng, 150).astype(np.float32)
    scores = (rng.randint(0, 5, 150) / 5.0).astype(np.float32)
    labels = rng.randint(0, 3, 150)
    max_coord = boxes.max()
    offsets = labels.astype(np.float64) * (max_coord + 1)
    shifted = boxes.astype(np.float64)
    shifted[:, [0, 1, 4]] += offsets[:, None]
    shifted[:, [2, 3, 5]] += offsets[:, None]
    for thr in (0.1, 1 / 3, 0.5):
        np.testing.assert_array_equal(ops_np.batched_nms_np(boxes, scores, labels, thr),
                                      ops_np.nms_np_plain(shifted, scores, thr))


@pytest.mark.parametrize("seed", range(3))
def test_nms_matches_jax_away_from_the_threshold(seed):
    rng = np.random.RandomState(20 + seed)
    boxes = random_boxes(rng, 400)
    scores = rng.rand(400).astype(np.float32)
    labels = rng.randint(0, 2, 400)
    ious = ops_np.box_iou_np(boxes, boxes)
    for thr in (0.1, 0.3, 0.6):
        assert np.abs(ious - thr).min() > 1e-9
        np.testing.assert_array_equal(ops_np.nms_np(boxes, scores, thr),
                                      j_nms_np(boxes, scores, thr))
        np.testing.assert_array_equal(ops_np.batched_nms_np(boxes, scores, labels, thr),
                                      j_batched_nms_np(boxes, scores, labels, thr))


# ------------------------------------------------------------------ WBC
@pytest.mark.parametrize("use_area,missing_weight", [(False, 1.0), (True, 0.5)])
@pytest.mark.parametrize("seed", range(3))
def test_wbc_matches_numpy_and_jax(seed, use_area, missing_weight):
    rng = np.random.RandomState(30 + seed)
    boxes = random_boxes(rng, 300)
    scores = rng.rand(300).astype(np.float32)
    weights = rng.rand(300).astype(np.float32)
    n_exp = rng.randint(1, 9, 300).astype(np.float64)
    native.NATIVE_CALLS.clear()
    for thr in (0.1, 0.5):
        kw = dict(iou_thresh=thr, score_thresh=0.05, use_area=use_area,
                  missing_weight=missing_weight)
        got = wbc_np(boxes, scores, weights, n_exp, **kw)
        assert len(got[1]) > 0
        for want in (wbc_np_plain(boxes, scores, weights, n_exp, **kw),
                     j_wbc_np(boxes, scores, weights, n_exp, **kw)):
            assert got[0].shape == want[0].shape
            np.testing.assert_allclose(got[0], want[0], rtol=WBC_RTOL, atol=0)
            np.testing.assert_allclose(got[1], want[1], rtol=WBC_RTOL, atol=0)
    assert native.NATIVE_CALLS["wbc_3d"] == 2


def test_batched_wbc_goes_native_per_class():
    rng = np.random.RandomState(40)
    boxes = random_boxes(rng, 200)
    scores, labels = rng.rand(200), rng.randint(0, 3, 200)
    native.NATIVE_CALLS.clear()
    b, s, l = batched_wbc_np(boxes, scores, labels, np.ones(200), np.full(200, 2.0), 0.3)
    assert native.NATIVE_CALLS["wbc_3d"] == 3 and len(s) == len(l) == len(b) > 0


def test_wbc_zero_volume_seed_leaves_the_pool():
    """A zero-volume seed overlaps nothing, not even itself: its cluster is
    empty and dropped, and the clustering goes on (both loops)."""
    boxes = np.asarray([[0, 0, 0, 4, 0, 4], [0, 0, 4, 4, 0, 4], [1, 1, 4, 4, 1, 4]], np.float64)
    scores = np.asarray([0.9, 0.8, 0.7])
    args = (boxes, scores, np.ones(3), np.ones(3), 0.3)
    got = wbc_np(*args)
    with np.errstate(invalid="ignore"):
        want = wbc_np_plain(*args)
    assert len(got[1]) == len(want[1]) == 1
    np.testing.assert_allclose(got[0], want[0], rtol=WBC_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=WBC_RTOL)


# ------------------------------------------------------------- matching
@pytest.mark.parametrize("seed", range(4))
def test_coco_match_equals_the_python_loop(seed):
    rng = np.random.RandomState(50 + seed)
    n_pred, n_gt = rng.randint(1, 40), rng.randint(1, 12)
    # IoUs in few levels: ties between GT, and values at the thresholds
    ious = rng.choice([0.0, 0.1, 0.25, 0.5, 0.55, 0.9, 1.0], (n_pred, n_gt))
    gt_ignore = np.sort(rng.rand(n_gt) < 0.3).astype(np.uint8)
    thresholds = np.asarray([0.1, 0.5, 0.75])
    native.NATIVE_CALLS.clear()
    got = native.coco_match_native(ious, gt_ignore, thresholds)
    want = matching.coco_match_plain(ious, gt_ignore, thresholds)
    assert native.NATIVE_CALLS["coco_match"] == 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_matching_batch_matches_jax(seed):
    rng = np.random.RandomState(60 + seed)
    batch = dict(pred_boxes=[], pred_classes=[], pred_scores=[], gt_boxes=[], gt_classes=[],
                 gt_ignore=[])
    for _ in range(4):
        gt = random_boxes(rng, rng.randint(0, 6))
        pred = np.concatenate([gt + rng.uniform(-4, 4, gt.shape).astype(np.float32),
                               random_boxes(rng, rng.randint(0, 30))])
        batch["pred_boxes"].append(pred)
        batch["pred_classes"].append(rng.randint(0, 2, len(pred)))
        batch["pred_scores"].append(rng.rand(len(pred)).astype(np.float32))
        batch["gt_boxes"].append(gt)
        batch["gt_classes"].append(rng.randint(0, 2, len(gt)))
        batch["gt_ignore"].append(rng.rand(len(gt)) < 0.2)
    thresholds = np.arange(0.1, 0.55, 0.05)
    native.NATIVE_CALLS.clear()
    got = matching.matching_batch(thresholds, **batch, max_detections=20)
    want = j_matching_batch(thresholds, **batch, max_detections=20)
    assert native.NATIVE_CALLS["coco_match"] > 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for c in g:
            assert sorted(g[c]) == sorted(w[c])
            for k in g[c]:
                np.testing.assert_array_equal(g[c][k], w[c][k], err_msg=k)
