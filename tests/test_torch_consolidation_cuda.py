"""The consolidation kernels on the card against their plain versions, at
``chip_smoke.py``'s sizes: the IoU matrix (#6, ``csrc/iou_matrix.cu``)
within ``TOL["iou_ulps"]`` float32 ulps, the suppression words (#8,
``csrc/suppression_matrix.cu``) and the greedy keep-scan identical, the WBC
cluster loop (``csrc/wbc_cluster.cu``) with identical clusters and scores
and boxes within ``TOL["wbc"]``. Imports neither JAX nor the JAX package, so
that it runs on a machine with the card:

    python -m pytest -m cuda tests/test_torch_consolidation_cuda.py

Every test needs a CUDA device and skips without one."""
import numpy as np
import pytest
import torch

import chip_smoke
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops.iou_matrix import iou_matrix, iou_matrix_plain
from nndetection_tpu_torch.ops.suppression import (
    nms_keep_scan, nms_keep_scan_plain, suppression_matrix, suppression_matrix_plain)
from nndetection_tpu_torch.ops.wbc_cluster import wbc_cluster, wbc_cluster_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _boxes(device, n, seed):
    return torch.from_numpy(chip_smoke.clumped_boxes(np.random.RandomState(seed), n)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", chip_smoke.IOU_SIZES)
def test_iou_matrix(cuda_device, n):
    b = _boxes(cuda_device, n, n)
    other = _boxes(cuda_device, n // 2 + 3, n + 1)
    n0 = LAUNCHES["iou_matrix"]
    for b2 in (b, other):
        got, want = iou_matrix(b, b2), iou_matrix_plain(b, b2)
        assert got.shape == want.shape == (n, b2.shape[0])
        ulps = int((got.view(torch.int32) - want.view(torch.int32)).abs().max())
        assert ulps <= chip_smoke.TOL["iou_ulps"]
    torch.cuda.synchronize()
    assert LAUNCHES["iou_matrix"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.1, 0.5])
@pytest.mark.parametrize("n", chip_smoke.SUPPRESSION_SIZES + (777,))
def test_suppression_words_and_keep_scan(cuda_device, n, thr):
    b = _boxes(cuda_device, n, n + 2)
    valid = torch.from_numpy(np.random.RandomState(n).rand(n) > 0.1).to(cuda_device)
    n0 = LAUNCHES["suppression_matrix"], LAUNCHES["nms_keep_scan"]
    words, pwords = suppression_matrix(b, thr), suppression_matrix_plain(b, thr)
    assert torch.equal(words, pwords)
    keep, pkeep = nms_keep_scan(words, valid), nms_keep_scan_plain(pwords, valid)
    assert torch.equal(keep, pkeep) and keep.any()
    torch.cuda.synchronize()
    assert (LAUNCHES["suppression_matrix"], LAUNCHES["nms_keep_scan"]) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("score_thresh", [0.0, float("-inf")])
def test_wbc_cluster(cuda_device, score_thresh):
    n, classes = chip_smoke.WBC_SHAPE
    rng = np.random.RandomState(3)
    b = _boxes(cuda_device, n, 4)
    dev = dict(device=cuda_device)
    scores = torch.from_numpy(rng.rand(n).astype(np.float32)).to(**dev)
    weights = torch.from_numpy((0.5 + rng.rand(n)).astype(np.float32)).to(**dev)
    n_exp = torch.from_numpy(rng.randint(1, 9, n).astype(np.float32)).to(**dev)
    labels = torch.from_numpy(rng.randint(0, classes, n).astype(np.int32)).to(**dev)
    valid = torch.from_numpy(rng.rand(n) > 0.05).to(**dev)
    args = (iou_matrix(b, b), b, scores, weights, n_exp, labels, valid, classes, 0.5, score_thresh)
    n0 = LAUNCHES["wbc_cluster"]
    got, want = wbc_cluster(*args), wbc_cluster_plain(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["wbc_cluster"] == n0 + 1
    assert torch.equal(got[2], want[2]) and got[2].any()
    tol = chip_smoke.TOL["wbc"]
    torch.testing.assert_close(got[1], want[1], **tol)
    torch.testing.assert_close(got[0], want[0], **tol)
