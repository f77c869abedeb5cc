"""The truncated NMS kernel (#7, ``csrc/nms_topk.cu``) on the card against
its plain version ``nms_topk_plain``: the shapes of ``chip_smoke.py`` (the
largest with its scratch in a global workspace), scores quantised to 8
levels, an image with no valid score, ``max_out`` above the boxes left
alive, N not a power of two with the scratch in shared memory and in the
workspace, and two runs equal; 2D boxes through the wrapper's lift to unit
depth. Indices and valid flags must be identical.
Imports neither JAX nor the JAX package, so that it runs on a machine with
the card:

    python -m pytest -m cuda tests/test_torch_nms_cuda.py

Every test needs a CUDA device and skips without one."""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from nndetection_tpu_torch.ops import LAUNCHES, lift_2d
from nndetection_tpu_torch.ops import nms as onms


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(params=["shared", "workspace"])
def scratch(request, monkeypatch):
    """Where the kernel's scratch sits: the plan's choice, or the global
    workspace at every size (a plan for a block with no room for it)."""
    if request.param == "workspace":
        monkeypatch.setattr(onms, "plan_nms_topk",
                            functools.partial(onms.plan_nms_topk, smem_bytes=0))
    return request.param


def _inputs(device, n_img, n, seed, levels=None):
    boxes, scores = chip_smoke.nms_boxes(np.random.RandomState(seed), n_img, n)
    if levels:
        scores = (scores * levels).floor() / levels
    return boxes.to(device), scores.to(device)


def _check(boxes, scores, thr, max_out):
    n = scores.shape[1]
    n0 = LAUNCHES["nms_topk"]
    idx, valid = onms.nms_topk(boxes, scores, thr, max_out)
    torch.cuda.synchronize()
    assert LAUNCHES["nms_topk"] == n0 + 1
    assert idx.dtype == torch.int64 and valid.dtype == torch.bool
    assert idx.shape == valid.shape == (scores.shape[0], max_out)
    steps = min(max_out, n)
    p_idx, p_valid = onms.nms_topk_plain(boxes, scores, thr, steps)
    assert torch.equal(valid[:, :steps], p_valid)
    assert torch.equal(idx[:, :steps], p_idx.long())
    assert not valid[:, steps:].any() and not idx[:, steps:].any()
    idx2, valid2 = onms.nms_topk(boxes, scores, thr, max_out)
    assert torch.equal(idx, idx2) and torch.equal(valid, valid2)
    return valid


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [None, 8])
@pytest.mark.parametrize("shape", chip_smoke.NMS_SHAPES)
def test_matches_plain(cuda_device, shape, levels):
    n_img, n, max_out = shape
    boxes, scores = _inputs(cuda_device, n_img, n, seed=n, levels=levels)
    for thr in (0.1, 0.6):
        assert _check(boxes, scores, thr, max_out).any()


@pytest.mark.cuda
def test_above_sixteen_thousand_boxes_uses_the_workspace(cuda_device):
    """Beyond 16384 boxes the keys leave shared memory; the previous kernel
    took up to 58112 boxes per image, and this one more."""
    assert onms.plan_nms_topk(58113, 100).ws_words > 0
    boxes, scores = _inputs(cuda_device, 1, 58113, seed=11, levels=8)
    assert _check(boxes, scores, 0.5, 100).any()


@pytest.mark.cuda
def test_all_invalid_and_few_alive(cuda_device, scratch):
    boxes, scores = _inputs(cuda_device, 3, 777, seed=1)
    scores[0] = float("-inf")      # nothing to select
    scores[1, 12:] = float("-inf")  # 12 candidates, max_out 100
    valid = _check(boxes, scores, 0.5, 100)
    assert not valid[0].any() and int(valid[1].sum()) <= 12


@pytest.mark.cuda
@pytest.mark.parametrize("n,max_out", [(1, 1), (7, 10), (33, 33), (999, 300), (1025, 100),
                                       (4097, 50), (16385, 100)])
def test_sizes_not_a_power_of_two(cuda_device, scratch, n, max_out):
    boxes, scores = _inputs(cuda_device, 2, n, seed=n + 1, levels=8)
    _check(boxes, scores, 0.3, max_out)


@pytest.mark.cuda
def test_tied_duplicates_and_signed_zeros(cuda_device, scratch):
    """Identical boxes with equal scores: only the lowest index of each
    group survives; -0 and +0 scores tie."""
    boxes, _ = _inputs(cuda_device, 1, 40, seed=3)
    boxes = boxes[:, :10].repeat_interleave(4, dim=1).contiguous()
    scores = torch.zeros((1, 40), device=cuda_device)
    scores[0, 1::2] = -0.0
    valid = _check(boxes, scores, 0.5, 40)
    assert int(valid.sum()) <= 10


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.1, 0.5, -0.1])
def test_nan_inf_and_signed_zero_coordinates(cuda_device, scratch, thr):
    """``chip_smoke.special_boxes`` (a NaN coordinate in one box of ten,
    +-inf in one of ten, flat boxes, signed zeros): a box with a NaN
    coordinate suppresses nothing and is suppressed by nothing, in the
    kernel as in the plain version."""
    rng = np.random.RandomState(17)
    boxes = torch.from_numpy(np.stack([chip_smoke.special_boxes(rng, 300) for _ in range(4)]))
    scores = torch.from_numpy(rng.rand(4, 300).astype(np.float32))
    scores[torch.from_numpy(rng.rand(4, 300) < 0.1)] = float("-inf")
    boxes, scores = boxes.to(cuda_device), scores.to(cuda_device)
    valid = _check(boxes, scores, thr, 300)
    nan = torch.isnan(boxes).any(-1) & torch.isfinite(scores)
    idx, _ = onms.nms_topk(boxes, scores, thr, 300)
    kept = torch.zeros(nan.shape, dtype=torch.int32, device=cuda_device)
    kept.scatter_add_(1, idx, valid.int())
    assert bool(nan.any()) and bool((kept[nan] == 1).all())


@pytest.mark.cuda
def test_public_wrapper_matches_the_cpu(cuda_device):
    boxes, scores = _inputs(cuda_device, 4, 500, seed=5)
    idx, valid = onms.nms_topk(boxes, scores, 0.4, 600)
    c_idx, c_valid = onms.nms_topk(boxes.cpu(), scores.cpu(), 0.4, 600)
    assert torch.equal(idx.cpu(), c_idx) and torch.equal(valid.cpu(), c_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [None, 8])
def test_2d_boxes_through_the_lift(cuda_device, scratch, levels):
    """2D boxes ``[I, N, 4]``: the wrapper lifts them to unit depth in front
    of the kernel, which then gives the plain version's indices on the
    lifted boxes, and the CPU wrapper's on the 2D boxes."""
    boxes, scores = _inputs(cuda_device, 4, 1000, seed=21, levels=levels)
    flat = boxes[..., :4].contiguous()
    for thr in (0.0, 0.5):
        valid = _check(lift_2d(flat), scores, thr, 100)
        assert valid.any()
        idx, v = onms.nms_topk(flat, scores, thr, 100)
        l_idx, l_v = onms.nms_topk(lift_2d(flat), scores, thr, 100)
        c_idx, c_v = onms.nms_topk(flat.cpu(), scores.cpu(), thr, 100)
        assert torch.equal(idx, l_idx) and torch.equal(v, l_v)
        assert torch.equal(idx.cpu(), c_idx) and torch.equal(v.cpu(), c_v)
