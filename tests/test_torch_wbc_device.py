"""The device formulation of weighted box clustering in the PyTorch port
(``core/boxes/wbc.py::batched_wbc``, one call of ``ops/wbc_cluster``)
against the JAX package's ``batched_wbc`` and the ensembler's
``batched_wbc_device``, on the CPU with the plain versions. Both sides are
float32 and sum in other orders: the clusters, their count and labels are
equal, boxes and scores agree at rtol 1e-5, atol 1e-6. The CUDA kernel is
held to its plain version on the card (``cuda`` marker and
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nndetection_tpu.inference.ensembler as jax_ensembler
from nndetection_tpu.core.boxes.wbc import batched_wbc as jax_batched_wbc
from nndetection_tpu.core.boxes.wbc import batched_wbc_np as jax_batched_wbc_np
from nndetection_tpu_torch.core.boxes.wbc import batched_wbc, wbc
from nndetection_tpu_torch.inference.ensembler import batched_wbc_device
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops.wbc_cluster import wbc_cluster, wbc_cluster_plain
from tests.test_torch_nms import random_boxes

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def case_inputs(seed, n, classes, pad=0):
    """Boxes in clumps (so clusters have several members), ``pad`` zero
    boxes marked invalid at the end, as the JAX device path pads."""
    rng = np.random.RandomState(seed)
    centers = random_boxes(rng, max(n // 6, 1))
    boxes = centers[rng.randint(0, len(centers), n)] + rng.uniform(-2, 2, (n, 6)).astype(np.float32)
    boxes[:, 2:4] = np.maximum(boxes[:, 2:4], boxes[:, 0:2] + 1)
    boxes[:, 5] = np.maximum(boxes[:, 5], boxes[:, 4] + 1)
    scores = rng.rand(n).astype(np.float32)
    labels = rng.randint(0, classes, n).astype(np.int32)
    weights = (0.5 + rng.rand(n)).astype(np.float32)
    n_exp = rng.randint(1, 9, n).astype(np.float32)
    valid = np.ones(n, bool)
    if pad:
        boxes = np.concatenate([boxes, np.zeros((pad, 6), np.float32)])
        scores = np.concatenate([scores, np.zeros(pad, np.float32)])
        labels = np.concatenate([labels, np.zeros(pad, np.int32)])
        weights = np.concatenate([weights, np.zeros(pad, np.float32)])
        n_exp = np.concatenate([n_exp, np.ones(pad, np.float32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    return boxes, scores, labels, weights, n_exp, valid


@pytest.mark.parametrize("n,classes,pad,score_thresh,use_area,missing_weight", [
    (60, 1, 0, 0.0, False, 1.0),
    (120, 2, 8, 0.0, False, 1.0),
    (120, 2, 0, 0.3, False, 1.0),
    (200, 3, 56, 0.1, True, 0.5),
])
def test_batched_wbc_matches_jax(n, classes, pad, score_thresh, use_area, missing_weight):
    arrays = case_inputs(n + classes, n, classes, pad)
    for iou_thresh in (0.2, 0.5):
        kw = dict(iou_thresh=iou_thresh, score_thresh=score_thresh, use_area=use_area,
                  missing_weight=missing_weight, num_classes=classes)
        got = batched_wbc(*map(torch.from_numpy, arrays), **kw)
        want = jax.jit(lambda *a: jax_batched_wbc(*a, **kw))(*map(jnp.asarray, arrays))
        gb, gs, gl, gv = (t.numpy() for t in got)
        wb, ws, wl, wv = (np.asarray(t) for t in want)
        assert gv.sum() > classes
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gs, ws, **TOL)
        np.testing.assert_allclose(gb, wb, **TOL)


def test_single_class_wbc_is_class_zero():
    boxes, scores, _, weights, n_exp, valid = map(torch.from_numpy, case_inputs(7, 80, 1))
    b, s, v = wbc(boxes, scores, weights, n_exp, valid, 0.4)
    bb, bs, _, bv = batched_wbc(boxes, scores, torch.zeros(80, dtype=torch.int32), weights,
                                n_exp, valid, 0.4)
    assert torch.equal(b, bb) and torch.equal(s, bs) and torch.equal(v, bv)


@pytest.mark.parametrize("classes", [1, 2])
def test_device_wbc_matches_jax_ensembler(classes):
    """``batched_wbc_device`` of both ensemblers (the JAX one pads to a power
    of two), and both against the host float64 WBC at its tolerances."""
    boxes, scores, labels, weights, n_exp, _ = case_inputs(11 + classes, 150, classes)
    labels = labels.astype(np.int64)
    kw = dict(iou_thresh=0.4, score_thresh=0.01)
    got = batched_wbc_device(boxes, scores, labels, weights, n_exp, **kw)
    want = jax_ensembler.batched_wbc_device(boxes, scores, labels, weights, n_exp, **kw)
    assert len(got[1]) == len(want[1]) > classes
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    host = jax_batched_wbc_np(boxes, scores, labels, weights, n_exp, **kw)
    o_got, o_host = np.lexsort((got[1], got[2])), np.lexsort((host[1], host[2]))
    np.testing.assert_array_equal(got[2][o_got], host[2][o_host])
    np.testing.assert_allclose(got[1][o_got], host[1][o_host], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0][o_got], host[0][o_host], rtol=1e-4, atol=1e-3)


def test_zero_volume_seed_ends_the_loop():
    """A valid zero-volume box is outside its own cluster (IoU 0 with
    itself); the loop drops it without output, where the JAX loop would
    not end."""
    boxes, scores, labels, weights, n_exp, valid = map(torch.from_numpy, case_inputs(5, 30, 1))
    boxes[0] = 0.0
    scores[0] = 2.0
    ob, os_, ov = wbc_cluster_plain(boxes, scores, weights, n_exp, labels, valid, 1, 0.3, 0.0)
    rb, rs, rw, re, rl, rv = (t[1:] for t in (boxes, scores, weights, n_exp, labels, valid))
    rest = wbc_cluster_plain(rb, rs, rw, re, rl, rv, 1, 0.3, 0.0)
    k = int(ov.sum())
    assert k == int(rest[2].sum()) > 0
    # the same clusters, summed over one element fewer
    torch.testing.assert_close(os_[0, :k], rest[1][0, :k], rtol=1e-6, atol=0)


def test_cpu_takes_the_plain_version():
    arrays = [torch.from_numpy(a) for a in case_inputs(3, 40, 2)]
    before = dict(LAUNCHES)
    batched_wbc(*arrays, iou_thresh=0.3, num_classes=2)
    assert dict(LAUNCHES) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,classes", [(1000, 2), (37, 1)])
def test_cuda_kernel_matches_plain(cuda_device, n, classes):
    boxes, scores, labels, weights, n_exp, valid = (
        torch.from_numpy(a).to(cuda_device) for a in case_inputs(n, n, classes, pad=5))
    n0 = LAUNCHES["wbc_cluster"]
    got = wbc_cluster(boxes, scores, weights, n_exp, labels, valid, classes, 0.4, 0.05)
    want = wbc_cluster_plain(boxes, scores, weights, n_exp, labels, valid, classes, 0.4, 0.05)
    torch.cuda.synchronize()
    assert LAUNCHES["wbc_cluster"] == n0 + 1
    # the plain version sums in the kernel's order: the same bits
    for g, w in zip(got, want):
        assert torch.equal(g, w)
