"""The WBC cluster kernel's decomposition (``csrc/wbc_cluster.cu``) on the
CPU: a NumPy model of its phases (the sort keys, the walk over chunks of 32
sorted candidates that finds the greedy seeds and each candidate's owner,
the second sort that groups the members by owner, the sums in increasing
index one float32 add at a time, the prefix count that places the emitted
clusters) equals ``wbc_cluster_plain``, the cluster-by-cluster loop that
defines the function, bit for bit; and ``plan_wbc`` at its limits. The
kernel itself is held to the plain version on the card
(``tests/test_torch_consolidation_cuda.py``, ``chip_smoke.py --phases=wbc``)."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nndetection_tpu_torch.ops import _build
from nndetection_tpu_torch.ops.wbc_cluster import SMEM_MAX, plan_wbc, wbc_cluster_plain
from test_torch_kernel_plans import sort_keys

torch.set_num_threads(1)

CHUNK, WARPS = 32, 16  # kChunk and kThreads / 32 of csrc/wbc_cluster.cu
NONE = np.uint64(0xFFFFFFFF)
F32 = np.float32


def with_volume(boxes):
    b = boxes.astype(F32)
    vol = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])) * (b[:, 5] - b[:, 4])
    return np.concatenate([b, vol[:, None]], 1)


def box_iou(a, b):
    """``box_iou`` of ``csrc/box_geometry.cuh`` in NumPy float32: row box
    ``a`` [7] against boxes ``b`` [m, 7]."""
    zero = F32(0)
    ix = np.maximum(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), zero)
    iy = np.maximum(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), zero)
    iz = np.maximum(np.minimum(a[5], b[:, 5]) - np.maximum(a[4], b[:, 4]), zero)
    inter = (ix * iy) * iz
    return inter / np.maximum((a[6] + b[:, 6]) - inter, F32(1e-12))


def walk(b, order, thr):
    """Phase 2: the sorted candidates ``order`` a chunk at a time. Returns
    each candidate's owner (a seed's rank, -1 for a seed outside its own
    cluster) and the seeds' sorted positions."""
    n_rem = len(order)
    owner = np.zeros(n_rem, np.int64)
    seeds = []
    for cursor in range(0, n_rem, CHUNK):
        cand = b[order[cursor:cursor + CHUNK]]
        m = len(cand)
        # warp w tests seeds w, w + 16, ...; the lowest hit over the warps
        prev = np.full(m, np.iinfo(np.int64).max)
        for w in range(WARPS):
            for k in range(w, len(seeds), WARPS):
                hit = (box_iou(b[order[seeds[k]]], cand) > thr) & (prev > k)
                prev[hit] = k
        rows = [(box_iou(cand[i], cand) > thr) & (np.arange(m) > i) for i in range(m)]
        # one warp, in order: a candidate left is a seed and takes its row
        left = prev == np.iinfo(np.int64).max
        sel = []
        for i in range(m):
            if left[i]:
                sel.append(i)
                left &= ~rows[i]
        for i in range(m):
            if i in sel:
                rank = len(seeds) + sel.index(i)
                owner[cursor + i] = rank if box_iou(cand[i], cand[i:i + 1])[0] > thr else -1
            elif prev[i] != np.iinfo(np.int64).max:
                owner[cursor + i] = prev[i]
            else:
                f = next(f for f in sel if rows[f][i])
                owner[cursor + i] = len(seeds) + sel.index(f)
        seeds += [cursor + i for i in sel]
    return owner, seeds


def model_wbc(boxes, scores, weights, n_exp, labels, valid, num_classes, iou_thr, score_thr,
              missing_weight=1.0):
    """The kernel's phases in NumPy, one class block after another."""
    n = len(scores)
    b = with_volume(boxes)
    thr, s_thr, mw = F32(iou_thr), F32(score_thr), F32(missing_weight)
    out_boxes = np.zeros((num_classes, n, 6), F32)
    out_scores = np.zeros((num_classes, n), F32)
    out_valid = np.zeros((num_classes, n), bool)
    for c in range(num_classes):
        # 1. keys of the remaining boxes, the others last; one sort
        remaining = valid & (labels == c) & np.isfinite(scores)
        keys = np.where(remaining, sort_keys(np.where(remaining, scores, F32(0))),
                        np.iinfo(np.uint64).max).astype(np.uint64)
        keys = np.sort(keys)
        n_rem = int(remaining.sum())
        order = (keys[:n_rem] & NONE).astype(np.int64)
        # 2. the walk
        owner, seeds = walk(b, order, thr)
        # 3. group: keys (owner, index), sorted; each seed's run
        key2 = np.sort((np.where(owner < 0, NONE, owner.astype(np.uint64)) << np.uint64(32))
                       | order.astype(np.uint64))
        run_owner = (key2 >> np.uint64(32)).astype(np.int64)
        run_idx = (key2 & NONE).astype(np.int64)
        count = 0
        for k, pos in enumerate(seeds):
            # 4. the sums in increasing index, one float32 add at a time
            sb = b[order[pos]]
            acc = np.zeros(10, F32)
            for j in run_idx[run_owner == k]:
                msw = box_iou(sb, b[j:j + 1])[0] * weights[j]
                ms = msw * scores[j]
                terms = [F32(1), n_exp[j], msw, ms] + [boxes[j, d] * ms for d in range(6)]
                acc = np.array([a + t for a, t in zip(acc, terms)], F32)
            n_found = acc[0]
            n_expected = acc[1] / max(n_found, F32(1))
            n_missing = max(F32(0), n_expected - n_found)
            denom = acc[2] + (n_missing * (acc[2] / max(n_found, F32(1)))) * mw
            score = acc[3] / max(denom, F32(1e-12))
            # 5. the emitted clusters in seed order
            if score > s_thr:
                out_boxes[c, count] = acc[4:] / max(acc[3], F32(1e-12))
                out_scores[c, count] = score
                out_valid[c, count] = True
                count += 1
    return out_boxes, out_scores, out_valid


def make_case(seed, n, classes, clumps=6, ties=0, signed_zero=False, zero_volume=0.0,
              invalid=0.0, nonfinite=0.0, foreign=0.0, one_cluster=False, nan_boxes=0.0):
    """Seeded boxes in clumps, and the degenerate inputs the tests draw;
    ``nan_boxes``: that share of the boxes with a NaN coordinate, and of the
    weights NaN, drawn last."""
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(10, 90, (max(n // clumps, 1), 3))[rng.randint(0, max(n // clumps, 1), n)]
    ctr = ctr + rng.uniform(-2, 2, (n, 3))
    if one_cluster:
        ctr[:] = 50 + rng.uniform(-0.2, 0.2, (n, 3))
    half = rng.uniform(2, 12, (n, 3)) if not one_cluster else rng.uniform(10, 10.5, (n, 3))
    lo, hi = ctr - half, ctr + half
    boxes = np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1).astype(F32)
    zv = rng.rand(n) < zero_volume
    boxes[zv, 2] = boxes[zv, 0]  # no extent along x
    scores = rng.rand(n).astype(F32)
    if ties:
        scores = (np.floor(scores * ties) / ties).astype(F32)
    if signed_zero:
        scores[rng.rand(n) < 0.3] = F32(-0.0)
        scores[rng.rand(n) < 0.3] = F32(0.0)
    odd = rng.rand(n) < nonfinite
    scores[odd] = rng.choice(np.array([np.inf, -np.inf, np.nan], F32), int(odd.sum()))
    labels = rng.randint(0, classes, n).astype(np.int32)
    labels[rng.rand(n) < foreign] = classes + 1
    weights = (0.5 + rng.rand(n)).astype(F32)
    n_exp = rng.randint(1, 9, n).astype(F32)
    valid = rng.rand(n) >= invalid
    if nan_boxes:
        bad = np.nonzero(rng.rand(n) < nan_boxes)[0]
        boxes[bad, rng.randint(0, 6, len(bad))] = np.nan
        weights[rng.rand(n) < nan_boxes] = np.nan
    return boxes, scores, weights, n_exp, labels, valid


def check_model_equals_plain(arrays, classes, iou_thr, score_thr, missing_weight=1.0):
    want = wbc_cluster_plain(*map(torch.from_numpy, arrays), classes, iou_thr, score_thr,
                             missing_weight)
    got = model_wbc(*arrays, classes, iou_thr, score_thr, missing_weight)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint8), w.numpy().view(np.uint8))
    return want


CASES = {
    # name: (make_case keywords, classes, iou_thr, score_thr)
    "clumps": (dict(n=100), 1, 0.3, 0.0),
    "ties": (dict(n=133, ties=3), 1, 0.2, 0.0),
    "signed_zero": (dict(n=70, signed_zero=True), 1, 0.2, 0.0),
    "zero_volume": (dict(n=90, zero_volume=0.3), 1, 0.3, 0.0),
    "all_emitted_and_iou_above_one": (dict(n=75), 1, 1.0, float("-inf")),
    "iou_thr_1_5": (dict(n=40), 2, 1.5, float("-inf")),
    "negative_iou_thr": (dict(n=50), 1, -0.1, 0.0),
    "invalid_nonfinite_foreign": (dict(n=120, invalid=0.2, nonfinite=0.2, foreign=0.2),
                                  3, 0.3, 0.1),
    "three_classes": (dict(n=157, clumps=3), 3, 0.1, 0.05),
    "one_box": (dict(n=1), 1, 0.5, 0.0),
    "one_cluster": (dict(n=77, one_cluster=True), 1, 0.5, 0.0),
    "nothing_remains": (dict(n=20, invalid=1.0), 2, 0.5, 0.0),
    # a box with a NaN coordinate joins no cluster (IoU NaN), and a seed of
    # its own emits nothing above 0, a zero row above -inf; a NaN weight
    # makes its cluster's score NaN, not emitted
    "nan_coordinates": (dict(n=96, nan_boxes=0.2), 2, 0.3, 0.0),
    "nan_coordinates_all_seeds_emitted": (dict(n=64, nan_boxes=0.3), 1, 0.3, float("-inf")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_model_of_the_kernel_equals_plain(name):
    kw, classes, iou_thr, score_thr = CASES[name]
    arrays = make_case(len(name), classes=classes, **kw)
    _, _, valid = check_model_equals_plain(arrays, classes, iou_thr, score_thr, 0.7)
    if name == "one_cluster":
        assert int(valid.sum()) == 1
    elif name == "all_emitted_and_iou_above_one":  # every box its own empty cluster
        assert int(valid.sum()) == kw["n"]
    elif name == "nothing_remains":
        assert not valid.any()
    else:
        assert valid.any()


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 110), classes=st.sampled_from([1, 3]),
       clumps=st.sampled_from([2, 6, 20]), ties=st.sampled_from([0, 2, 5]),
       signed_zero=st.booleans(), zero_volume=st.sampled_from([0.0, 0.2]),
       invalid=st.sampled_from([0.0, 0.3]), nonfinite=st.sampled_from([0.0, 0.2]),
       foreign=st.sampled_from([0.0, 0.2]), one_cluster=st.booleans(),
       iou_thr=st.sampled_from([0.0, 0.1, 0.4, 0.9, 1.0, 1.2]),
       score_thr=st.sampled_from([float("-inf"), 0.0, 0.3]),
       missing_weight=st.sampled_from([0.0, 0.5, 1.0]))
def test_model_of_the_kernel_equals_plain_drawn(seed, n, classes, clumps, ties, signed_zero,
                                                zero_volume, invalid, nonfinite, foreign,
                                                one_cluster, iou_thr, score_thr, missing_weight):
    arrays = make_case(seed, n, classes, clumps, ties, signed_zero, zero_volume, invalid,
                       nonfinite, foreign, one_cluster)
    check_model_equals_plain(arrays, classes, iou_thr, score_thr, missing_weight)


# ------------------------------------------------------------------ the plan
GEO = _build.constants("wbc_cluster.cu")


def kernel_accepts(plan, n):
    """``wbc_cluster_launch``'s own checks of the shared memory and the
    workspace."""
    scratch = 8 * plan.n_pad + GEO["kBoxBytes"] * n
    header = 4 * GEO["kHeaderWords"]
    if plan.ws_words:
        return plan.smem_bytes >= header and 8 * plan.ws_words >= scratch and plan.ws_words % 2 == 0
    return plan.smem_bytes >= header + scratch


def test_plan_reads_the_kernel_source():
    assert (GEO["kSeg"], GEO["kChunk"], GEO["kThreads"] // 32) == (64, CHUNK, WARPS)
    assert 2 + 2 * GEO["kChunk"] + GEO["kThreads"] // 32 <= GEO["kHeaderWords"]
    assert GEO["kBoxBytes"] == 32 + 2 * 4


@pytest.mark.parametrize("n", [1, 2, 31, 33, 63, 64, 65, 999, 1000, 1025, 4096, 4160, 4161,
                               20000, 57600, 100_000])
def test_plan_sizes(n):
    plan = plan_wbc(n)
    assert plan.n == n and plan.n_pad >= max(n, 64) and plan.n_pad & (plan.n_pad - 1) == 0
    assert plan.n_pad < 2 * max(n, 64)
    assert plan.smem_bytes <= SMEM_MAX and kernel_accepts(plan, n)
    # shared memory up to 4160 boxes on the H100, the workspace above: no cap
    # below the 57600 boxes the previous kernel took
    assert (plan.ws_words > 0) == (n > 4160)


def test_plan_limits():
    with pytest.raises(ValueError):
        plan_wbc(0)
    with pytest.raises(ValueError):
        plan_wbc(2 ** 30 + 1)
    # the largest size in shared memory fills it exactly
    assert dataclasses.astuple(plan_wbc(4160)) == (4160, 8192, 512 + 8 * 8192 + 40 * 4160, 0)
    assert plan_wbc(4160).smem_bytes == SMEM_MAX
    # the first above it: the scratch in the workspace, slices of an even
    # number of words, the header alone in shared memory
    assert dataclasses.astuple(plan_wbc(4161)) == (4161, 8192, 512,
                                                   2 * -(-(8 * 8192 + 40 * 4161) // 16))
    # a card with less shared memory, or none to spare, moves a size there
    small = plan_wbc(1000, smem_bytes=0)
    assert small.ws_words > 0 and small.smem_bytes == 512 and kernel_accepts(small, 1000)
    assert plan_wbc(1000).ws_words == 0
