"""The consolidation kernels on the card against their plain versions, at
``chip_smoke.py``'s sizes: the IoU matrix (#6, ``csrc/iou_matrix.cu``)
within ``TOL["iou_ulps"]`` float32 ulps (0: the same bits) and NaN at the
same positions, on clumped and dense boxes and on the named cases of
``test_torch_iou_tile_walk.py`` (NaN, +-inf and signed-zero coordinates)
at every ``rows_per_warp`` and each ``M % 4``, the suppression words (#8,
``csrc/suppression_matrix.cu``) and the greedy keep-scan identical (also
on the named edge cases of ``test_torch_nms_scan_walk.py``, one launch
each, and at 16384 boxes), the WBC
cluster kernel (``csrc/wbc_cluster.cu``) bit for bit equal to its plain
version, two calls equal, on the edge cases of ``test_torch_wbc_walk.py``
with its scratch in shared memory and in the workspace, and the device WBC
as one launch of it and none of #6; 2D boxes through the wrapper's lift to
unit depth. Imports neither JAX nor the JAX package, so that it runs on a
machine with the card:

    python -m pytest -m cuda tests/test_torch_consolidation_cuda.py

Every test needs a CUDA device and skips without one."""
import numpy as np
import pytest
import torch

import chip_smoke
from nndetection_tpu_torch.core.boxes.wbc import batched_wbc
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops import wbc_cluster as owbc
from nndetection_tpu_torch.ops.iou_matrix import iou_matrix, iou_matrix_plain, plan_iou
from nndetection_tpu_torch.ops.suppression import (
    nms_keep_scan, nms_keep_scan_plain, suppression_matrix, suppression_matrix_plain)
from nndetection_tpu_torch.ops.wbc_cluster import wbc_cluster, wbc_cluster_plain
# by module name: a machine with the card may have another package named `tests`
from test_torch_iou_tile_walk import IOU_CASES, make_iou_case
from test_torch_nms_scan_walk import SCAN_CASES, make_scan_case, ranked
from test_torch_wbc_walk import CASES, make_case


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _boxes(device, n, seed):
    return torch.from_numpy(chip_smoke.clumped_boxes(np.random.RandomState(seed), n)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["clumped", "dense"])
@pytest.mark.parametrize("n", chip_smoke.IOU_SIZES)
def test_iou_matrix(cuda_device, n, kind):
    make = chip_smoke.clumped_boxes if kind == "clumped" else chip_smoke.dense_boxes
    b = torch.from_numpy(make(np.random.RandomState(n), n)).to(cuda_device)
    other = torch.from_numpy(make(np.random.RandomState(n + 1), n // 2 + 3)).to(cuda_device)
    n0 = LAUNCHES["iou_matrix"]
    for b2 in (b, other):
        got, want = iou_matrix(b, b2), iou_matrix_plain(b, b2)
        assert got.shape == want.shape == (n, b2.shape[0])
        # raises where NaN positions differ or above TOL["iou_ulps"]
        chip_smoke.iou_ulps(f"{n} {kind}", got, want)
        del got, want
    torch.cuda.synchronize()
    assert LAUNCHES["iou_matrix"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(IOU_CASES))
@pytest.mark.parametrize("rows_per_warp", [1, 4, 16])
def test_iou_matrix_named_cases(cuda_device, name, rows_per_warp):
    """Each named case both ways round and against itself, on a forced
    grid: NaN at the same positions as the plain version's on the CPU
    copies, the same bits everywhere else (the card's max gives +0 where
    the CPU's may give -0: compared on the card, the plain version gives
    the kernel's bits)."""
    b1, b2 = make_iou_case(name)
    for x, y in ((b1, b2), (b2, b1), (b1, b1)):
        x, y = torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device)
        plan = plan_iou(len(x), len(y), 132, rows_per_warp=rows_per_warp)
        got, want = iou_matrix(x, y, plan), iou_matrix_plain(x, y)
        torch.cuda.synchronize()
        assert chip_smoke.same_bits(got, want)
        assert not bool(torch.signbit(got[got == 0]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 4, 127, 128, 129, 130, 131, 258, 1001])
@pytest.mark.parametrize("n", [1, 9, 130])
def test_iou_matrix_store_paths(cuda_device, n, m):
    """Partial edge tiles, one row or column, and each ``M % 4``: the
    16-byte stores where ``M % 4 == 0``, single floats otherwise, at the
    plan's grid and at R = 16."""
    rng = np.random.RandomState(n * 10000 + m)
    b1 = torch.from_numpy(chip_smoke.special_boxes(rng, n)).to(cuda_device)
    b2 = torch.from_numpy(chip_smoke.clumped_boxes(rng, m, 40.0)).to(cuda_device)
    want = iou_matrix_plain(b1, b2)
    for plan in (None, plan_iou(n, m, 132, rows_per_warp=16)):
        assert chip_smoke.same_bits(iou_matrix(b1, b2, plan), want)


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
@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_suppression_and_keep_scan_edge_cases(cuda_device, name):
    """Each named case, its rows in their given order (invalid rows
    anywhere) and ranked as ``nms_mask`` ranks them, at each of its
    thresholds: the words and the flags identical to the plain versions on
    the CPU copies, one launch of each kernel."""
    boxes, scores, valid, thrs = make_scan_case(name)
    for thr in thrs:
        for b, v in ((boxes, valid), ranked(boxes, scores, valid)[1:]):
            b, v = torch.from_numpy(b), torch.from_numpy(v)
            n0 = LAUNCHES["suppression_matrix"], LAUNCHES["nms_keep_scan"]
            words = suppression_matrix(b.to(cuda_device), thr)
            keep = nms_keep_scan(words, v.to(cuda_device))
            torch.cuda.synchronize()
            assert (LAUNCHES["suppression_matrix"], LAUNCHES["nms_keep_scan"]) == (n0[0] + 1,
                                                                                  n0[1] + 1)
            pwords = suppression_matrix_plain(b, thr)
            assert keep.dtype == torch.bool and keep.device == words.device
            assert torch.equal(words.cpu(), pwords)
            assert torch.equal(keep.cpu(), nms_keep_scan_plain(pwords, v))


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
    args = (b, scores, weights, n_exp, labels, valid, classes, 0.5, score_thresh)
    n0 = LAUNCHES["wbc_cluster"]
    got, want = wbc_cluster(*args), wbc_cluster_plain(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["wbc_cluster"] == n0 + 1
    assert got[2].any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def force_route(monkeypatch, route):
    """The workspace route for any N: a plan with no shared memory to spare."""
    if route == "workspace":
        plan = owbc.plan_wbc
        monkeypatch.setattr(owbc, "plan_wbc", lambda n: plan(n, smem_bytes=0))


def check_wbc_on_the_card(device, arrays, classes, iou_thr, score_thr, missing_weight=1.0):
    """The kernel twice against the plain version on the CPU copies of the
    same inputs (the plain version gives the same bits on either device):
    all three outputs bit for bit, one launch per call."""
    cpu = [torch.from_numpy(a) for a in arrays]
    dev = [t.to(device) for t in cpu]
    rest = (classes, iou_thr, score_thr, missing_weight)
    n0 = LAUNCHES["wbc_cluster"]
    got, again = wbc_cluster(*dev, *rest), wbc_cluster(*dev, *rest)
    want = wbc_cluster_plain(*cpu, *rest)
    torch.cuda.synchronize()
    assert LAUNCHES["wbc_cluster"] == n0 + 2
    for g, a, w in zip(got, again, want):
        if g.dtype == torch.float32:  # the same bits, NaN at the same positions
            assert chip_smoke.same_bits(g, a) and chip_smoke.same_bits(g.cpu(), w)
        else:
            assert torch.equal(g, a) and torch.equal(g.cpu(), w)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "workspace"])
@pytest.mark.parametrize("name", list(CASES))
def test_wbc_cluster_edge_cases(cuda_device, monkeypatch, name, route):
    force_route(monkeypatch, route)
    kw, classes, iou_thr, score_thr = CASES[name]
    check_wbc_on_the_card(cuda_device, make_case(len(name), classes=classes, **kw), classes,
                          iou_thr, score_thr, 0.7)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "workspace"])
@pytest.mark.parametrize("n,classes", [(chip_smoke.WBC_SHAPE[0], chip_smoke.WBC_SHAPE[1]),
                                       (4160, 1), (4161, 1)])
def test_wbc_cluster_sizes(cuda_device, monkeypatch, n, classes, route):
    """The table shape, the largest N whose scratch fits in shared memory
    and the first above it, on either route (the plan's own route for 4161
    is the workspace)."""
    force_route(monkeypatch, route)
    arrays = make_case(n, n, classes, ties=64, invalid=0.05)
    _, _, valid = check_wbc_on_the_card(cuda_device, arrays, classes, 0.5, 0.0)
    assert valid.any()


@pytest.mark.cuda
def test_wbc_cluster_plain_on_the_card_equals_the_cpu(cuda_device):
    arrays = make_case(9, 150, 2, ties=8)
    cpu = [torch.from_numpy(a) for a in arrays]
    on_card = wbc_cluster_plain(*(t.to(cuda_device) for t in cpu), 2, 0.3, 0.0)
    for g, w in zip(on_card, wbc_cluster_plain(*cpu, 2, 0.3, 0.0)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_device_wbc_is_one_launch_and_no_iou_matrix(cuda_device):
    boxes, scores, weights, n_exp, labels, valid = (
        torch.from_numpy(a).to(cuda_device) for a in make_case(1, 1000, 2))
    before = dict(LAUNCHES)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    batched_wbc(boxes, scores, labels, weights, n_exp, valid, iou_thresh=0.4, num_classes=2)
    torch.cuda.synchronize()
    assert LAUNCHES["wbc_cluster"] == before.get("wbc_cluster", 0) + 1
    assert LAUNCHES["iou_matrix"] == before.get("iou_matrix", 0)
    # outputs and input copies, no N x N float32 matrix (4 MB here)
    assert torch.cuda.max_memory_allocated(cuda_device) - base < 4 * 1000 * 1000


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "workspace"])
def test_wbc_cluster_2d_boxes(cuda_device, monkeypatch, route):
    """2D boxes ``[N, 4]``: the wrapper lifts them to unit depth in front of
    the kernel and slices z off its cluster boxes; the card gives the CPU
    wrapper's bits (the plain version on the same lifted boxes), one launch
    per call."""
    force_route(monkeypatch, route)
    arrays = list(make_case(23, 2000, 2, ties=64, invalid=0.05, zero_volume=0.02))
    arrays[0] = np.ascontiguousarray(arrays[0][:, :4])
    cpu = [torch.from_numpy(a) for a in arrays]
    dev = [t.to(cuda_device) for t in cpu]
    rest = (2, 0.5, 0.0, 0.7)
    n0 = LAUNCHES["wbc_cluster"]
    got, again = wbc_cluster(*dev, *rest), wbc_cluster(*dev, *rest)
    want = wbc_cluster(*cpu, *rest)
    torch.cuda.synchronize()
    assert LAUNCHES["wbc_cluster"] == n0 + 2
    assert got[0].shape == (2, 2000, 4) and want[2].any()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and torch.equal(g.cpu(), w)
