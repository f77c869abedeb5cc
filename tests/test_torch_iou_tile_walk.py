"""The IoU matrix kernel's decomposition (``csrc/iou_matrix.cu``, #6) on the
CPU. A NumPy model of its grid (128 columns and ``8 x rows_per_warp`` rows
a block, each box staged by one thread, lane ``l`` owning columns ``4l ..
4l + 3`` with 16-byte stores where ``M % 4 == 0``, else columns ``l, l +
32, l + 64, l + 96`` with one store each, the warps walking the block's
rows, the division skipped where the quotient is the intersection itself)
writes every element once and equals ``iou_matrix_plain`` bit for bit, on
the named cases (NaN, +-inf and signed-zero coordinates, flat boxes, one
dense clump, boxes that never meet) and on partial edge tiles, ``N = 1``,
``M = 1`` and each ``M % 4``. ``plan_iou`` is pinned at the sizes that
``chip_smoke.py`` runs. The kernel itself is held to the plain version on
the card (``tests/test_torch_consolidation_cuda.py``, ``chip_smoke.py``).

Imports no JAX, so that the card's tests can import the named cases."""
import numpy as np
import pytest
import torch

import chip_smoke
from nndetection_tpu_torch.ops import _build
from nndetection_tpu_torch.ops.iou_matrix import IouPlan, iou_matrix, iou_matrix_plain, plan_iou

torch.set_num_threads(1)

GEO = _build.constants("iou_matrix.cu")
WARPS = GEO["kThreads"] // 32
PER_LANE = GEO["kColsPerLane"]
COLS = 32 * PER_LANE
F32 = np.float32
LANES = np.arange(32)


# ----------------------------------------------------------- the cases
def boxes_apart(rng, n):
    """Small boxes on a wide grid: no two meet."""
    ctr = (np.arange(n)[:, None] * np.array([37.0, 11.0, 5.0])) % 997.0
    half = rng.uniform(0.5, 1.5, (n, 3))
    lo, hi = ctr - half, ctr + half
    return np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1).astype(F32)


def case_special(rng):
    """NaN, +-inf and signed-zero coordinates and flat boxes, on both sides."""
    return chip_smoke.special_boxes(rng, 70), chip_smoke.special_boxes(rng, 45)


def case_touching_at_zero(rng):
    """Boxes ending at -0 along x beside boxes starting at +0: min - max is
    -0, whose max with +0 is +0 on the card (PTX: +0 above -0)."""
    b = chip_smoke.special_boxes(rng, 36)
    b = b[np.isfinite(b).all(1)]
    left, right = b.copy(), b.copy()
    left[:, 2], left[:, 0] = F32(-0.0), -np.abs(left[:, 0]) - 1
    right[:, 0], right[:, 2] = F32(0.0), np.abs(right[:, 2]) + 1
    return np.concatenate([left, right]), np.concatenate([right, left])[::-1].copy()


def case_zero_volume(rng):
    """Zero padding and flat boxes against themselves: the clamped union
    gives 0, not 0 / 0."""
    b = chip_smoke.clumped_boxes(rng, 40, 60.0)
    b[5:12] = 0.0
    b[20:25, 5] = b[20:25, 4]
    return b, b.copy()


def case_dense(rng):
    """One clump: every pair meets, every IoU takes its division."""
    return chip_smoke.dense_boxes(rng, 150), chip_smoke.dense_boxes(rng, 131)


def case_apart(rng):
    """No pair meets: every IoU skips its division."""
    return boxes_apart(rng, 90), boxes_apart(rng, 77) + F32(500)


IOU_CASES = {
    "special": case_special,
    "touching_at_zero": case_touching_at_zero,
    "zero_volume": case_zero_volume,
    "dense": case_dense,
    "apart": case_apart,
}


def make_iou_case(name):
    """``(boxes1 [N, 6], boxes2 [M, 6])`` float32 of a named case, seeded by
    its name."""
    return IOU_CASES[name](np.random.RandomState(sum(map(ord, name))))


def assert_same_bits(got, want):
    """NaN at the same positions, the same bits everywhere else."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == F32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


# ----------------------------------------------------------- the model
def max_nan(a, b):
    """``max_nan`` of ``box_geometry.cuh`` (PTX ``max.NaN.f32``): NaN where
    either operand is NaN, and +0 above -0."""
    zeros = (a == 0) & (b == 0)
    return np.where(zeros, np.where(np.signbit(a) & np.signbit(b), F32(-0.0), F32(0.0)),
                    np.maximum(a, b)).astype(F32)


def min_nan(a, b):
    zeros = (a == 0) & (b == 0)
    return np.where(zeros, np.where(np.signbit(a) | np.signbit(b), F32(-0.0), F32(0.0)),
                    np.minimum(a, b)).astype(F32)


def stage(boxes, first, count, size):
    """The staged boxes ``first .. first + size - 1`` with their volumes
    ``[size, 7]``, zeros past ``count``."""
    b = np.zeros((size, 7), F32)
    k = max(0, min(size, count - first))
    b[:k, :6] = boxes[first:first + k]
    with np.errstate(invalid="ignore", over="ignore"):
        b[:k, 6] = ((b[:k, 2] - b[:k, 0]) * (b[:k, 3] - b[:k, 1])) * (b[:k, 5] - b[:k, 4])
    return b


def pair_iou(row, cols):
    """``pair_iou`` of the kernel: row box ``[7]`` against column boxes
    ``[..., 7]``. Where it skips the division, the quotient is checked to be
    the intersection, bit for bit."""
    zero = F32(0)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        inter = ((max_nan(min_nan(row[2], cols[..., 2]) - max_nan(row[0], cols[..., 0]), zero)
                  * max_nan(min_nan(row[3], cols[..., 3]) - max_nan(row[1], cols[..., 1]), zero))
                 * max_nan(min_nan(row[5], cols[..., 5]) - max_nan(row[4], cols[..., 4]), zero))
        uni = max_nan((row[6] + cols[..., 6]) - inter, F32(1e-12))
        quotient = inter / uni
    divide = (inter != 0) | np.isnan(uni)
    skipped = ~divide
    np.testing.assert_array_equal(quotient[skipped].view(np.int32), inter[skipped].view(np.int32))
    return np.where(divide, quotient, inter).astype(F32), skipped


def model_iou(boxes1, boxes2, plan):
    """The kernel's grid, staging, row walk and stores; returns the matrix
    and the number of pairs that skipped the division. Every element is
    written exactly once, each 16-byte store at a 16-byte aligned offset."""
    n, m = len(boxes1), len(boxes2)
    rows = WARPS * plan.rows_per_warp
    grid = (-(-m // COLS), -(-n // rows))
    assert plan.blocks == grid[0] * grid[1]
    flat = np.zeros(n * m, F32)
    writes = np.zeros(n * m, np.int64)
    t = np.arange(COLS)
    slot = (t % PER_LANE, t // PER_LANE) if plan.vector else (t // 32, t % 32)
    j0 = PER_LANE * LANES if plan.vector else LANES
    skipped = 0
    for by in range(grid[1]):
        row0 = by * rows
        s_row = stage(boxes1, row0, n, rows)
        for bx in range(grid[0]):
            col0 = bx * COLS
            s_col = np.zeros((PER_LANE, 32, 7), F32)
            s_col[slot] = stage(boxes2, col0, m, COLS)
            cols = s_col.transpose(1, 0, 2)  # [lane, k, 7]
            j = col0 + j0
            for warp in range(WARPS):
                for r in range(warp, rows, WARPS):
                    i = row0 + r
                    if i >= n:
                        break
                    q, skip = pair_iou(s_row[r], cols)  # [lane, k]
                    if plan.vector:
                        on = j < m
                        base = i * m + j[on]
                        assert (base % PER_LANE == 0).all() and (j[on] + PER_LANE <= m).all()
                        idx = base[:, None] + np.arange(PER_LANE)
                    else:
                        jj = j[:, None] + 32 * np.arange(PER_LANE)
                        on = jj < m
                        idx = i * m + jj[on]
                    flat[idx] = q[on]
                    writes[idx] += 1
                    skipped += int(skip[on].sum())
    assert (writes == 1).all()
    return flat.reshape(n, m), skipped


def check_model(boxes1, boxes2, plan=None):
    """The model against ``iou_matrix_plain`` on the CPU. The CPU's
    ``torch.maximum(-0, +0)`` gives either zero by its vector path; the
    card's (``fmaxf``, PTX ``max.f32``) gives +0, as the kernel and the model
    do. So where the plain version holds -0 the model holds +0; every other
    element has the same bits, NaN at the same positions."""
    n, m = len(boxes1), len(boxes2)
    plan = plan or plan_iou(n, m, 132)
    got, skipped = model_iou(boxes1, boxes2, plan)
    want = iou_matrix_plain(torch.from_numpy(boxes1), torch.from_numpy(boxes2)).numpy()
    neg_zero = (want == 0) & np.signbit(want)
    assert not np.signbit(got[got == 0]).any()
    assert_same_bits(np.where(neg_zero, F32(0.0), got), np.where(neg_zero, F32(0.0), want))
    return got, skipped


# ----------------------------------------------------------- the tests
def test_model_reads_the_kernel_source():
    assert GEO["kThreads"] % 32 == 0 and PER_LANE == 4
    assert COLS + WARPS * GEO["kMaxRowsPerWarp"] <= GEO["kThreads"]


@pytest.mark.parametrize("name", list(IOU_CASES))
@pytest.mark.parametrize("rows_per_warp", [1, 2, 16])
def test_model_equals_plain_on_named_cases(name, rows_per_warp):
    b1, b2 = make_iou_case(name)
    for x, y in ((b1, b2), (b2, b1), (b1, b1)):
        plan = plan_iou(len(x), len(y), 132, rows_per_warp=rows_per_warp)
        got, skipped = check_model(x, y, plan)
        if name == "special":
            assert np.isnan(got).any() and np.isfinite(got).any() and (got > 0).any()
        elif name == "dense":
            assert skipped == 0 and (got > 0).all()
        elif name == "apart" and x is not y:
            assert skipped == got.size and not got.any()
        elif name == "zero_volume" and x is y:
            np.testing.assert_array_equal(got[5:12, 5:12], 0.0)


@pytest.mark.parametrize("n,m", [(1, 1), (1, 4), (5, 1), (1, 131), (9, 128), (9, 129),
                                 (17, 130), (17, 131), (33, 256), (70, 257), (70, 258),
                                 (130, 259)])
@pytest.mark.parametrize("rows_per_warp", [1, 4, 16])
def test_model_equals_plain_at_edge_sizes(n, m, rows_per_warp):
    """Partial tiles on both axes, each ``M % 4``, one row or column."""
    rng = np.random.RandomState(n * 1000 + m)
    b1, b2 = chip_smoke.special_boxes(rng, n), chip_smoke.clumped_boxes(rng, m, 40.0)
    plan = plan_iou(n, m, 132, rows_per_warp=rows_per_warp)
    assert plan.vector == (m % 4 == 0)
    check_model(b1, b2, plan)
    check_model(b2[:n] if m >= n else b2, b1[:m] if n >= m else b1)


def test_the_skip_keeps_the_sign_of_zero():
    """``pair_iou``'s skip against the division itself: +-0 over every
    union a pair can have (the clamp's 1e-12, finite, +inf, NaN)."""
    row = np.array([0, 0, 1, 1, 0, 1, 1], F32)
    cols = np.zeros((8, 7), F32)
    cols[:, 0] = 5  # apart along x: max(1 - 5, 0) = +0
    cols[:, 6] = np.array([-1, 0, 1e-30, 3, 1e30, np.inf, -np.inf, np.nan], F32)
    q, skipped = pair_iou(row, cols)
    assert skipped.sum() == 7  # -inf and 0 clamp to 1e-12, +inf stays: only the NaN union divides
    assert np.isnan(q[-1]) and not np.signbit(q[:-1]).any()
    # -0 intersections: the skip returns -0, as the division does
    inter = np.array([-0.0, 0.0], F32)
    for uni in (F32(1e-12), F32(7), F32(np.inf)):
        np.testing.assert_array_equal((inter / uni).view(np.int32), inter.view(np.int32))


def test_plan_at_the_smoke_sizes():
    """The grid ``plan_iou`` gives the H100 (132 SMs) at the sizes
    ``chip_smoke.py`` times: R = 2 at 1000 boxes (504 blocks), 8 at 4096, 16
    at 16384 and 4097; 16-byte stores exactly where ``M % 4 == 0``."""
    got = {(n, m): plan_iou(n, m, 132) for n, m in
           [(1000, 1000), (4096, 4096), (16384, 16384), (4097, 4097), (1000, 1001),
            (4097, 4093), (1, 1)]}
    assert got[(1000, 1000)] == IouPlan(2, True, 8 * 63)
    assert got[(4096, 4096)] == IouPlan(8, True, 2048)
    assert got[(16384, 16384)] == IouPlan(16, True, 16384)
    assert got[(4097, 4097)] == IouPlan(16, False, 33 * 33)
    assert got[(1000, 1001)] == IouPlan(2, False, 8 * 63)
    assert got[(4097, 4093)] == IouPlan(16, False, 32 * 33)
    assert got[(1, 1)] == IouPlan(2, False, 1)
    for n in chip_smoke.IOU_SIZES:
        plan = plan_iou(n, n, 132)
        assert plan.vector == (n % 4 == 0) and plan.blocks >= 504
    with pytest.raises(ValueError):
        plan_iou(10, 10, 132, rows_per_warp=GEO["kMaxRowsPerWarp"] + 1)
    assert plan_iou(10, 10, 132, rows_per_warp=1) == IouPlan(1, False, 2)


def test_cpu_wrapper_is_the_plain_version_on_special_boxes():
    b1, b2 = (torch.from_numpy(b) for b in make_iou_case("special"))
    assert_same_bits(iou_matrix(b1, b2).numpy(), iou_matrix_plain(b1, b2).numpy())
