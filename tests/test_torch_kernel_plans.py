"""The launch plans of the instance-norm statistics kernel (#1,
``ops/instance_norm.py::plan_in_stats``) and of the truncated NMS kernel (#7,
``ops/nms.py::plan_nms_topk``), on the CPU, at every shape ``chip_smoke.py``
runs them: the grid pinned, the row splits covering every selected row
exactly once as the kernel walks them, the shared memory the kernel needs.
Also the NMS kernel's algorithm (sort once by an order-preserving key, then
a walk over chunks of 32 candidates) as a NumPy model, against
``nms_topk_plain``."""
import numpy as np
import pytest
import torch

import chip_smoke
from nndetection_tpu_torch.ops import _build
from nndetection_tpu_torch.ops import instance_norm as inorm
from nndetection_tpu_torch.ops import nms as onms

torch.set_num_threads(1)

# (x4 shape [B, D, Q, C], (start, step)) -> (splits, rows per split, channel
# blocks) on a 132-SM card: the LUNA stages at batch 2 and 8, both schedules
# (stages 4-5 are below 2 x 8 planes: all planes under both)
IN_STATS = {
    ((2, 96, 16384, 32), (0, 1)): (132, 11916, 1),
    ((2, 96, 16384, 32), (4, 8)): (132, 1490, 1),
    ((2, 48, 4096, 64), (0, 1)): (96, 2048, 1),
    ((2, 48, 4096, 64), (4, 8)): (96, 256, 1),
    ((2, 24, 1024, 128), (0, 1)): (66, 373, 2),
    ((2, 24, 1024, 128), (4, 8)): (24, 128, 2),
    ((2, 6, 64, 320), (0, 1)): (3, 128, 5),
    ((2, 3, 16, 320), (0, 1)): (1, 48, 5),
    ((8, 96, 16384, 32), (0, 1)): (33, 47663, 1),
    ((8, 96, 16384, 32), (4, 8)): (33, 5958, 1),
    ((8, 48, 4096, 64), (0, 1)): (33, 5958, 1),
    ((8, 48, 4096, 64), (4, 8)): (33, 745, 1),
    ((8, 24, 1024, 128), (0, 1)): (16, 1536, 2),
    ((8, 24, 1024, 128), (4, 8)): (16, 192, 2),
    ((8, 6, 64, 320), (0, 1)): (3, 128, 5),
    ((8, 3, 16, 320), (0, 1)): (1, 48, 5),
}


def smoke_in_stats_cases():
    """Every (x4 shape, planes) ``chip_smoke.norm_kernel_checks`` runs."""
    cases = []
    for batch in chip_smoke.IN_BATCHES:
        for _, d, h, w, c in chip_smoke.LUNA_STAGES:
            for stride in (None, 8):
                case = ((batch, d, h * w, c), inorm.plane_schedule(d, stride))
                if case not in cases:
                    cases.append(case)
    return cases


def test_in_stats_table_is_the_smoke_shapes():
    assert sorted(IN_STATS) == sorted(smoke_in_stats_cases())


def kernel_rows(plan, split):
    """The (plane, q) pairs one split reads, decoded as
    ``in_stats_kernel`` decodes its row range: one division per plane."""
    lo, hi = plan.split_rows(split)
    out, r = [], lo
    while r < hi:
        p = r // plan.q
        q0 = r - p * plan.q
        q1 = min(plan.q, q0 + (hi - r))
        out.extend((plan.start + p * plan.step, q) for q in range(q0, q1))
        r += q1 - q0
    return out


@pytest.mark.parametrize("shape,planes", list(IN_STATS))
def test_in_stats_plan(shape, planes):
    b, d, q, c = shape
    plan = inorm.plan_in_stats(b, d, q, c, *planes, n_sms=132)
    assert (plan.splits, plan.rows_per_split, plan.n_cb) == IN_STATS[(shape, planes)]
    assert plan.n_rows == len(range(planes[0], d, planes[1])) * q
    assert plan.cb == min(c, inorm.IN_STATS_CB) and plan.n_cb * plan.cb >= c
    # one wave at most, each split long enough unless there is one, and no
    # more splits than the last block's combine holds in registers
    assert plan.blocks <= inorm.IN_STATS_BLOCKS_PER_SM * 132
    assert plan.splits == 1 or plan.rows_per_split >= inorm.IN_STATS_MIN_ROWS
    cbp = 1 << (plan.cb - 1).bit_length()
    assert plan.splits <= inorm.IN_STATS_HOLD * (inorm.IN_STATS_THREADS // cbp)
    assert plan.ws_floats == 2 * plan.blocks * plan.cb
    # the splits tile [0, n_rows) in order, none empty
    bounds = [plan.split_rows(s) for s in range(plan.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == plan.n_rows
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("shape,planes", [
    ((2, 24, 1024, 128), (4, 8)),   # splits inside a plane
    ((2, 6, 64, 320), (0, 1)),      # splits across planes
    ((1, 20, 35, 4), (4, 8)),       # planes 4 and 12 of 20, rows not a power of two
    ((3, 17, 9, 6), (0, 1)),        # one split
    ((1, 40, 300, 1), (4, 8)),      # C = 1
    ((2, 16, 200, 100), (4, 8)),    # C = 100: a full and a partial channel block
])
def test_in_stats_splits_cover_every_selected_row_once(shape, planes):
    b, d, q, c = shape
    plan = inorm.plan_in_stats(b, d, q, c, *planes, n_sms=132)
    seen = [row for s in range(plan.splits) for row in kernel_rows(plan, s)]
    want = [(p, qq) for p in range(planes[0], d, planes[1]) for qq in range(q)]
    assert seen == want


def test_in_stats_plan_small_card_and_edges():
    # fewer SMs: fewer splits, the same coverage
    plan = inorm.plan_in_stats(2, 96, 16384, 32, 4, 8, n_sms=16)
    assert plan.blocks <= inorm.IN_STATS_BLOCKS_PER_SM * 16
    assert plan.splits * plan.rows_per_split >= plan.n_rows
    # one image of 64 channels on a large card: the combine's hold caps it
    plan = inorm.plan_in_stats(1, 96, 16384, 64, 0, 1, n_sms=2000)
    assert plan.splits == inorm.IN_STATS_HOLD * inorm.IN_STATS_THREADS // 64
    assert plan.splits * plan.rows_per_split >= plan.n_rows
    plan = inorm.plan_in_stats(2, 16, 200, 100, 4, 8)
    assert (plan.cb, plan.n_cb) == (64, 2)
    with pytest.raises(ValueError):
        inorm.plan_in_stats(1, 3, 16, 8, 4, 8)  # no plane selected


# (images, boxes, max_out) -> (padded keys, shared memory bytes, workspace
# words per image): the scratch in shared memory up to 16384 boxes, in a
# global workspace above
NMS = {
    (16, 1000, 100): (1024, 8848, 0),
    (2, 10000, 100): (16384, 131728, 0),
    (2, 20000, 100): (32768, 256, 32818),
}
NMS_GEO = _build.constants("nms_topk.cu")


def test_nms_table_is_the_smoke_shapes():
    assert sorted(NMS) == sorted(chip_smoke.NMS_SHAPES)


def kernel_smem_need(n, max_out, n_pad, ws):
    """``nms_topk_launch``'s own check of the dynamic shared memory."""
    header = 4 * NMS_GEO["kHeaderWords"]
    return header + (0 if ws else 8 * n_pad + 4 * min(max_out, n))


@pytest.mark.parametrize("shape", list(NMS))
def test_nms_plan(shape):
    _, n, max_out = shape
    plan = onms.plan_nms_topk(n, max_out)
    assert (plan.n_pad, plan.smem_bytes, plan.ws_words) == NMS[shape]
    assert (plan.n, plan.max_out) == (n, max_out)
    assert plan.smem_bytes == kernel_smem_need(n, max_out, plan.n_pad, plan.ws_words)
    assert plan.smem_bytes <= onms.SMEM_MAX
    if plan.ws_words:  # the keys, then the references two to a word
        assert plan.ws_words == plan.n_pad + -(-min(max_out, n) // 2)


@pytest.mark.parametrize("n", [1, 2, 7, 31, 32, 33, 63, 65, 999, 1000, 1025, 5000, 6000, 16384,
                               16385, 58113])
def test_nms_plan_sizes(n):
    plan = onms.plan_nms_topk(n, 100)
    seg = NMS_GEO["kSeg"]
    assert plan.n_pad >= max(n, seg) and plan.n_pad & (plan.n_pad - 1) == 0
    assert plan.n_pad < 2 * max(n, seg)
    # shared memory up to 16384 boxes, beyond the workspace: no cap below
    # the 58112 boxes the previous kernel took
    assert (plan.ws_words > 0) == (n > 16384)
    assert plan.smem_bytes == kernel_smem_need(n, 100, plan.n_pad, plan.ws_words)


def test_nms_plan_limits():
    with pytest.raises(ValueError):
        onms.plan_nms_topk(0, 100)
    with pytest.raises(ValueError):
        onms.plan_nms_topk(10, 0)
    # every selection of 16384 boxes: the references still fit beside the
    # keys
    plan = onms.plan_nms_topk(16384, 16384)
    assert plan.ws_words == 0 and plan.smem_bytes == 256 + 8 * 16384 + 4 * 16384
    # a smaller shared memory moves a size to the workspace
    small = onms.plan_nms_topk(1000, 100, smem_bytes=8000)
    assert small.ws_words == 1024 + 50 and small.smem_bytes == 4 * NMS_GEO["kHeaderWords"]


def test_plans_read_the_kernel_sources():
    """The geometry the plans use is the kernels' own: the constants parsed
    from ``csrc``, and the kernel's header holds its counts and masks."""
    assert NMS_GEO["kSeg"] == 2 * 32 and NMS_GEO["kChunk"] == 32
    assert 2 + NMS_GEO["kThreads"] // 32 + NMS_GEO["kChunk"] <= NMS_GEO["kHeaderWords"]
    geo = _build.constants("instance_norm_stats.cu")
    assert (inorm.IN_STATS_CB, inorm.IN_STATS_THREADS, inorm.IN_STATS_HOLD,
            inorm.IN_STATS_BLOCKS_PER_SM) == (geo["kMaxCB"], geo["kThreads"], geo["kHold"],
                                              geo["kBlocksPerSm"])


# ------------------------------------------------ the NMS kernel's algorithm
def sort_keys(scores):
    """``sort_key`` of ``csrc/nms_topk.cu``: the inverted order-preserving
    map of the score above the index; ascending keys give descending scores,
    ties by index, -inf last, -0 tied with +0."""
    s = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    u = s.view(np.uint32)
    asc = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    return ((~asc).astype(np.uint64) << np.uint64(32)) | np.arange(len(s), dtype=np.uint64)


def iou_above(k, b, thr):
    """The kernel's ``iou_above`` in NumPy float32: box ``k`` (selected)
    against boxes ``b`` ``[m, 7]`` (coordinates and volume)."""
    zero = np.float32(0)
    ix = np.maximum(np.minimum(k[2], b[:, 2]) - np.maximum(k[0], b[:, 0]), zero)
    iy = np.maximum(np.minimum(k[3], b[:, 3]) - np.maximum(k[1], b[:, 1]), zero)
    iz = np.maximum(np.minimum(k[5], b[:, 5]) - np.maximum(k[4], b[:, 4]), zero)
    inter = (ix * iy) * iz
    uni = np.maximum((k[6] + b[:, 6]) - inter, np.float32(1e-12))
    return inter / uni > np.float32(thr)


def sort_once_nms(boxes, scores, thr, max_out, chunk=32):
    """One image through the kernel's walk in NumPy float32: sort once,
    then chunks of ``chunk`` candidates in order, each tested against the
    boxes selected in earlier chunks and resolved in order with the chunk's
    own suppression rows."""
    order = np.argsort(sort_keys(scores), kind="stable")
    n_valid = 0 if np.isnan(scores).any() else int((scores > -np.inf).sum())
    b = boxes[order].astype(np.float32)
    b = np.concatenate([b, (((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))
                            * (b[:, 5] - b[:, 4]))[:, None]], 1)
    idx, valid, sel = np.zeros(max_out, np.int64), np.zeros(max_out, bool), []
    for cursor in range(0, n_valid, chunk):
        if len(sel) == max_out:
            break
        cand = b[cursor:min(cursor + chunk, n_valid)]
        left = np.ones(len(cand), bool)
        for k in sel:
            left &= ~iou_above(b[k], cand, thr)
        rows = [iou_above(cand[i], cand, thr) & (np.arange(len(cand)) > i)
                for i in range(len(cand))]
        for i in range(len(cand)):
            if left[i] and len(sel) < max_out:
                idx[len(sel)], valid[len(sel)] = order[cursor + i], True
                sel.append(cursor + i)
                left &= ~rows[i]
    return idx, valid


def random_boxes(rng, n):
    ctr = rng.uniform(10, 90, (n, 3))
    sz = rng.uniform(2, 25, (n, 3))
    return np.stack([ctr[:, 0] - sz[:, 0], ctr[:, 1] - sz[:, 1], ctr[:, 0] + sz[:, 0],
                     ctr[:, 1] + sz[:, 1], ctr[:, 2] - sz[:, 2], ctr[:, 2] + sz[:, 2]],
                    1).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "ties8", "all_inf", "signed_zero", "nan",
                                  "few_alive", "one_box", "clumped"])
def test_sort_once_walk_matches_plain(case):
    rng = np.random.RandomState(7)
    n, max_out, thr = 333, 100, 0.3
    boxes = random_boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    scores[rng.rand(n) < 0.1] = -np.inf
    if case == "ties8":
        scores = np.floor(scores * 8) / 8
    elif case == "all_inf":
        scores[:] = -np.inf
    elif case == "signed_zero":
        scores = np.where(rng.rand(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    elif case == "nan":
        scores[5] = np.nan
    elif case == "few_alive":
        scores[10:] = -np.inf
        max_out = 40
    elif case == "one_box":
        boxes, scores, max_out = boxes[:1], scores[:1] * 0 + 0.5, 3
    elif case == "clumped":  # many suppressions: the walk crosses chunks
        boxes = chip_smoke.clumped_boxes(rng, n, 60.0)
    scores = scores.astype(np.float32)
    idx, valid = sort_once_nms(boxes, scores, thr, max_out)
    steps = min(max_out, len(scores))
    p_idx, p_valid = onms.nms_topk_plain(torch.from_numpy(boxes)[None],
                                         torch.from_numpy(scores)[None], thr, steps)
    np.testing.assert_array_equal(valid[:steps], p_valid[0].numpy())
    np.testing.assert_array_equal(idx[:steps], p_idx[0].numpy())
    assert not valid[steps:].any() and not idx[steps:].any()


def kernel_sort(keys):
    """``sort_keys`` of ``csrc/nms_topk.cu`` in NumPy: each warp's 64 keys
    (lane l holds keys 64 s + l and 64 s + 32 + l) sorted through
    ``bitonic_step`` with shuffles for k <= 64, then for every larger k the
    strides of 64 and more through the scratch and the rest in registers."""
    keys = keys.copy()
    n_pad = len(keys)
    lane = np.arange(32)

    def step(a, b, e0, k, j):
        if j == 32:
            swap = (a > b) == ((e0 & k) == 0)
            return np.where(swap, b, a), np.where(swap, a, b)
        pa, pb = a[lane ^ j], b[lane ^ j]
        lower = (lane & j) == 0
        a = np.where(lower == ((e0 & k) == 0), np.minimum(a, pa), np.maximum(a, pa))
        b = np.where(lower == (((e0 + 32) & k) == 0), np.minimum(b, pb), np.maximum(b, pb))
        return a, b

    def registers(ks):
        for seg in range(n_pad // 64):
            e0 = seg * 64 + lane
            a, b = keys[e0], keys[e0 + 32]
            for k in ks:
                for j in ([jj for jj in (32, 16, 8, 4, 2, 1) if jj <= k // 2]):
                    a, b = step(a, b, e0, k, j)
            keys[e0], keys[e0 + 32] = a, b

    registers([2, 4, 8, 16, 32, 64])
    k = 128
    while k <= n_pad:
        j = k // 2
        while j >= 64:
            for p in range(n_pad // 2):
                i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
                l = i | j
                if (keys[i] > keys[l]) == ((i & k) == 0):
                    keys[i], keys[l] = keys[l], keys[i]
            j //= 2
        registers([k])
        k *= 2
    return keys


@pytest.mark.parametrize("n_pad", [64, 128, 1024, 4096])
def test_kernel_sort_network_sorts(n_pad):
    rng = np.random.RandomState(n_pad)
    n = n_pad - n_pad // 5
    scores = np.floor(rng.rand(n) * 8).astype(np.float32) / 8  # heavy ties
    scores[rng.rand(n) < 0.1] = -np.inf
    keys = np.full(n_pad, np.iinfo(np.uint64).max, np.uint64)
    keys[:n] = sort_keys(scores)
    got = kernel_sort(keys)
    np.testing.assert_array_equal(got, np.sort(keys))
    # the order greedy NMS walks: score descending, index ascending
    order = (got[:n] & np.uint64(0xffffffff)).astype(np.int64)
    np.testing.assert_array_equal(order, np.lexsort((np.arange(n), -scores)))
