"""NaN, +-inf and signed-zero box coordinates through the port's plain
versions of the three kernels that share ``box_iou``
(``csrc/box_geometry.cuh``): #6 (``iou_matrix_plain``), #7
(``nms_topk_plain``) and the WBC cluster loop (``wbc_cluster_plain`` under
``batched_wbc``), against the JAX package on the CPU. Every max and min of
the IoU carries NaN on both sides (``torch.maximum``, ``torch.clamp``,
``jnp.maximum``), so a box with a NaN coordinate has IoU NaN with every box:
it suppresses nothing, is suppressed by nothing and joins no cluster. The
kernels are held to these plain versions on the card, on the same named
cases (``tests/test_torch_consolidation_cuda.py``,
``tests/test_torch_nms_cuda.py``, ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nndetection_tpu.core.boxes.wbc import batched_wbc as jax_batched_wbc
from nndetection_tpu.ops.pallas_ops import iou_matrix_pallas
from nndetection_tpu_torch.core.boxes.wbc import batched_wbc
from nndetection_tpu_torch.ops.iou_matrix import iou_matrix_plain
from nndetection_tpu_torch.ops.nms import nms_topk_plain
from tests.test_torch_iou_tile_walk import make_iou_case
from tests.test_torch_nms import _pallas
from tests.test_torch_wbc_device import TOL, case_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["special", "touching_at_zero", "zero_volume"])
def test_iou_matrix_plain_matches_pallas(name):
    """NaN at the same positions; elsewhere within the tolerance that
    ``tests/test_torch_iou_matrix.py`` holds the two to (XLA's CPU
    arithmetic differs from PyTorch's by an ulp at some pairs; +0 and -0
    compare equal)."""
    b1, b2 = make_iou_case(name)
    for x, y in ((b1, b2), (b2, b1)):
        got = iou_matrix_plain(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(iou_matrix_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, **TOL)
        if name == "special":
            assert np.isnan(got[np.isnan(x).any(1)]).all() and np.isinf(x).any()
            assert np.isnan(got).sum() > np.isnan(x).any(1).sum() * len(y)


@pytest.mark.parametrize("n,max_out", [(97, 97), (200, 30)])
@pytest.mark.parametrize("thr", [0.1, 0.5, -0.1])
def test_nms_topk_plain_matches_pallas(n, max_out, thr):
    """The same keep list: a box with a NaN coordinate is kept once its
    score comes up, whatever the threshold, and removes nothing."""
    rng = np.random.RandomState(n + max_out)
    boxes = chip_smoke.special_boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.1
    p_idx, p_valid = _pallas(boxes, scores, valid, thr, max_out)
    masked = np.where(valid, scores, np.float32(-np.inf))
    idx, keep = nms_topk_plain(torch.from_numpy(boxes)[None], torch.from_numpy(masked)[None],
                               thr, max_out)
    np.testing.assert_array_equal(keep[0].numpy(), p_valid)
    np.testing.assert_array_equal(idx[0].numpy(), p_idx)
    kept = set(idx[0][keep[0]].tolist())
    nan_boxes = set(np.nonzero(np.isnan(boxes).any(1) & valid)[0].tolist())
    assert kept & nan_boxes
    if max_out == n:  # every step runs: each valid NaN box comes up and is kept
        assert nan_boxes <= kept


def _emitted(out, classes):
    """Each class's emitted clusters in the order they formed."""
    boxes, scores, _, valid = (np.asarray(t) for t in out)
    n = len(scores) // classes
    return [(boxes[c * n:(c + 1) * n][valid[c * n:(c + 1) * n]],
             scores[c * n:(c + 1) * n][valid[c * n:(c + 1) * n]]) for c in range(classes)]


def _jax_wbc(arrays, **kw):
    return jax.jit(lambda *a: jax_batched_wbc(*a, **kw))(*map(jnp.asarray, arrays))


def _port_wbc(arrays, **kw):
    return batched_wbc(*map(torch.from_numpy, arrays), **kw)


@pytest.mark.parametrize("classes", [1, 2])
def test_wbc_nan_boxes_join_no_cluster(classes):
    """Valid boxes with a NaN coordinate change no cluster and emit none
    (each is a seed outside its own cluster, of score 0): the port's
    clusters are those of the same input without them, bit for bit, and
    match the JAX ``batched_wbc`` on that input. The JAX loop cannot take
    them: a valid one, as a seed with IoU NaN with itself, never leaves
    ``remaining`` and the loop does not end; an invalid one still enters
    each cluster's box sum as NaN x 0 and makes every box NaN."""
    arrays = list(case_inputs(31 + classes, 90, classes))
    rng = np.random.RandomState(classes)
    nan = rng.rand(90) < 0.15
    arrays[0][nan, rng.randint(0, 6, int(nan.sum()))] = np.nan
    arrays[0][~nan & (rng.rand(90) < 0.2), 0] = -0.0
    without = [a[~nan] for a in arrays]
    kw = dict(iou_thresh=0.3, score_thresh=0.0, num_classes=classes)
    got = _emitted(_port_wbc(arrays, **kw), classes)
    ref = _emitted(_port_wbc(without, **kw), classes)
    want = _emitted(_jax_wbc(without, **kw), classes)
    assert nan.sum() > 3 and sum(len(s) for _, s in got) > classes
    for (gb, gs), (rb, rs), (wb, ws) in zip(got, ref, want):
        np.testing.assert_array_equal(gb.view(np.int32), rb.view(np.int32))
        np.testing.assert_array_equal(gs.view(np.int32), rs.view(np.int32))
        np.testing.assert_allclose(gs, ws, **TOL)
        np.testing.assert_allclose(gb, wb, **TOL)


def test_wbc_nan_weights_match_jax():
    """A NaN weight makes its cluster's score NaN on both sides: not
    emitted, its members gone."""
    arrays = list(case_inputs(41, 120, 2))
    arrays[3][np.random.RandomState(0).rand(120) < 0.1] = np.nan
    kw = dict(iou_thresh=0.3, score_thresh=0.0, num_classes=2)
    got, want = _port_wbc(arrays, **kw), _jax_wbc(arrays, **kw)
    gb, gs, gl, gv = (t.numpy() for t in got)
    wb, ws, wl, wv = (np.asarray(t) for t in want)
    assert 2 < gv.sum() < 120
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, **TOL)
    np.testing.assert_allclose(gb, wb, **TOL)
