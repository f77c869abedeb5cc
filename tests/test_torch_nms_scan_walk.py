"""The untruncated NMS kernels' decomposition (``csrc/suppression_matrix.cu``)
on the CPU. A NumPy model of the suppression words (#8: the grid over the
tiles on and above the diagonal, the mirror tile's zero words, lane ``l``
holding columns ``l`` and ``32 + l``, two ballots per row) equals
``suppression_matrix_plain`` word for word, every word written once. A
model of the block-wise keep-scan (the chain inside the diagonal word,
jumping from kept row to kept row; word ``k + 1`` of the kept rows first,
in warp 0's register; the tail ORs of block ``k - 1`` beside the chain of
block ``k``, on slots of the removed vector that the chain does not touch)
equals ``nms_keep_scan_plain``, and through the model of #8 the JAX
package's ``nms_mask``, bit for bit, on named edge cases and drawn ones.
The kernels themselves are held to the plain versions on the card
(``tests/test_torch_consolidation_cuda.py``, ``chip_smoke.py``).

JAX is imported only where the model is compared with it, so that the card's
tests can import the named cases without it."""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nndetection_tpu_torch.core.boxes.nms import nms_mask
from nndetection_tpu_torch.ops import _build
from nndetection_tpu_torch.ops.suppression import (
    nms_keep_scan_plain, num_words, suppression_matrix_plain)
from test_torch_wbc_walk import with_volume

torch.set_num_threads(1)

BITS = 64
GEO = _build.constants("suppression_matrix.cu")
TILE_WARPS = GEO["kTileThreads"] // 32
ROWS_PER_WARP = BITS // TILE_WARPS
TAIL_THREADS = GEO["kScanThreads"] - 32
F32 = np.float32
ALL = (1 << 64) - 1
SENTINEL = 0x5EED_0BAD_F00D_CAFE


def to_u64(words: torch.Tensor) -> np.ndarray:
    """int64 words as Python ints of their 64 bits."""
    return np.vectorize(lambda v: int(v) & ALL, otypes=[object])(words.numpy())


# ------------------------------------------------------------ #8's model
def box_iou_inter(a, b):
    """``box_iou`` of ``test_torch_wbc_walk`` (NaN carried through its max
    and min, as the kernel's ``suppresses``) and the intersection."""
    zero = F32(0)
    ix = np.maximum(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), zero)
    iy = np.maximum(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), zero)
    iz = np.maximum(np.minimum(a[5], b[:, 5]) - np.maximum(a[4], b[:, 4]), zero)
    inter = (ix * iy) * iz
    return inter / np.maximum((a[6] + b[:, 6]) - inter, F32(1e-12)), inter


def upper_tile(t):
    """``upper_tile`` of the kernel: tile ``t = c(c+1)/2 + r``, ``r <= c``."""
    c = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while c * (c + 1) // 2 > t:
        c -= 1
    while (c + 1) * (c + 2) // 2 <= t:
        c += 1
    return t - c * (c + 1) // 2, c


def model_words(boxes_sorted, thr):
    """The words as the kernel's blocks write them: ``[N, W]`` Python ints,
    each written exactly once (asserted)."""
    n = len(boxes_sorted)
    w = num_words(n)
    out = np.full((n, w), SENTINEL, dtype=object)
    writes = np.zeros((n, w), np.int64)
    thr = F32(thr)
    padded = np.zeros((w * BITS, 7), F32)
    padded[:n] = with_volume(boxes_sorted)
    for t in range(w * (w + 1) // 2):
        rt, ct = upper_tile(t)
        assert 0 <= rt <= ct < w
        i0, j0 = rt * BITS, ct * BITS
        if ct != rt:  # the mirror tile's zero words
            for i in range(j0, min(j0 + BITS, n)):
                out[i, rt] = 0
                writes[i, rt] += 1
        cols = padded[j0:j0 + BITS]
        j = j0 + np.arange(BITS)
        for warp in range(TILE_WARPS):
            for s in range(ROWS_PER_WARP):
                i = i0 + warp * ROWS_PER_WARP + s
                if i >= n:
                    break
                with np.errstate(invalid="ignore", divide="ignore"):
                    iou, inter = box_iou_inter(padded[i], cols)
                # at thr >= 0 a pair whose boxes do not meet is decided
                # without the IoU
                meets = inter > 0 if thr >= 0 else True
                bit = (j > i) & (j < n) & meets & (iou > thr)
                ballot_lo = sum(1 << l for l in range(32) if bit[l])
                ballot_hi = sum(1 << l for l in range(32) if bit[32 + l])
                out[i, ct] = (ballot_hi << 32) | ballot_lo
                writes[i, ct] += 1
    assert (writes == 1).all()
    return out


# ------------------------------------------------------- the scan's model
def model_keep_scan(words, valid):
    """The keep-scan's iterations: in iteration ``k`` warp 0 resolves block
    ``k``'s chain while the tail threads OR block ``k - 1``'s kept rows into
    words ``k + 1 ...``; both read the removed vector as the barrier left it
    and write slots the other does not touch."""
    n, w = words.shape
    removed = [0] * w
    keep = np.zeros(n, bool)
    carry = 0  # warp 0's register: word k of block k - 1's kept rows
    for k in range(w):
        rows = range(k * BITS, min(k * BITS + BITS, n))
        before = list(removed)
        # warp 0: the chain over the block's valid rows, kept row to kept row
        valid_mask = sum(1 << (i - k * BITS) for i in rows if valid[i])
        diag = [int(words[i, k]) for i in rows]
        nxt = [int(words[i, k + 1]) if k + 1 < w else 0 for i in rows]
        live = valid_mask & ~(before[k] | carry) & ALL
        kept, steps = 0, 0
        while live:
            r = (live & -live).bit_length() - 1
            kept |= 1 << r
            live &= ~(diag[r] | (1 << r)) & ALL
            steps += 1
        assert steps == bin(kept).count("1") <= len(rows)
        carry = 0
        for r in range(len(rows)):
            if kept >> r & 1:
                keep[k * BITS + r] = True
                carry |= nxt[r]
        chain_slots = {k}
        # the tail threads: block k - 1's kept rows into words k + 1 ...
        tail_slots = set()
        if k >= 1:
            kept_before = before[k - 1]  # stored there by warp 0 in iteration k - 1
            tail_slots.add(k - 1)
            for t in range(TAIL_THREADS):
                for col in range(k + 1 + t, w, TAIL_THREADS):
                    acc = 0
                    for r in range(BITS):
                        if kept_before >> r & 1:
                            acc |= int(words[(k - 1) * BITS + r, col])
                    removed[col] = before[col] | acc
                    tail_slots.add(col)
        assert not chain_slots & tail_slots
        removed[k] = kept  # word k is dead: it holds block k's kept rows
    return keep


# ---------------------------------------------------------------- cases
def spread_boxes(n, half=3.0):
    """``n`` cubes of half size ``half`` on a grid, 10 apart: no two overlap."""
    g = np.arange(n)
    ctr = np.stack([10.0 * (g % 8), 10.0 * (g // 8 % 8), 10.0 * (g // 64)], 1) + 20.0
    lo, hi = ctr - half, ctr + half
    return np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1).astype(F32)


def jitter(box, rng, amount=0.3):
    return (box + rng.uniform(-amount, amount, 6)).astype(F32)


def clumped(rng, n, clumps=6):
    ctr = rng.uniform(10, 90, (max(n // clumps, 1), 3))[rng.randint(0, max(n // clumps, 1), n)]
    ctr = ctr + rng.uniform(-2, 2, (n, 3))
    half = rng.uniform(2, 12, (n, 3))
    lo, hi = ctr - half, ctr + half
    return np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1).astype(F32)


def descending(n):
    """Scores that rank the boxes in index order."""
    return np.linspace(1.0, 0.01, max(n, 1))[:n].astype(F32)


def case_sizes(n):
    def make(rng):
        return clumped(rng, n), rng.rand(n).astype(F32), rng.rand(n) > 0.1, (0.1, 0.3, 0.6)
    return make


def case_block_edges(rng):
    """Row 63 suppresses row 64, so row 65 (overlapping 64 only) stays; a
    kept row of block 0 (5) suppresses rows 130 and 140 of block 2."""
    n = 192
    b = spread_boxes(n)
    b[64] = b[63] + F32(1.0)
    b[65] = b[64] + F32(2.0)
    b[130] = jitter(b[5], rng)
    b[140] = jitter(b[5], rng)
    return b, descending(n), np.ones(n, bool), (0.1, 0.3)


def case_block_suppressed(rng):
    """Every row of block 1 is a near copy of a kept row of block 0."""
    n = 160
    b = spread_boxes(n)
    for i in range(64, 128):
        b[i] = jitter(b[i - 64], rng)
    return b, descending(n), np.ones(n, bool), (0.3,)


def case_invalid_suppressors(rng):
    """Pairs (2m, 2m + 1) overlap; the rows that would suppress are invalid."""
    n = 130
    b = spread_boxes(n)
    for i in range(1, n, 2):
        b[i] = jitter(b[i - 1], rng)
    valid = np.arange(n) % 2 == 1
    return b, descending(n), valid, (0.3,)


def case_all_invalid(rng):
    n = 100
    return clumped(rng, n), rng.rand(n).astype(F32), np.zeros(n, bool), (0.3,)


def case_identical(rng):
    n = 100
    b = np.repeat(clumped(rng, 1), n, 0)
    return b, rng.rand(n).astype(F32), np.ones(n, bool), (0.3, 0.99)


def case_tied_scores(rng):
    n = 150
    return clumped(rng, n), (rng.randint(0, 4, n) / 4.0).astype(F32), rng.rand(n) > 0.1, (0.2,)


def case_thr_at_least_one(rng):
    """IoU is at most 1: nothing suppresses, identical boxes neither."""
    n = 90
    b = clumped(rng, n)
    b[10:20] = b[0]
    return b, rng.rand(n).astype(F32), rng.rand(n) > 0.1, (1.0, 1.5)


def case_thr_negative(rng):
    """Every pair's IoU (0 where boxes do not meet) is above the threshold:
    the first valid row suppresses all the others."""
    n = 140
    return clumped(rng, n), rng.rand(n).astype(F32), rng.rand(n) > 0.2, (-0.1, -1.0)


def case_nan_coordinates(rng):
    """Boxes with a NaN coordinate: their IoU is NaN, above no threshold, so
    they neither suppress nor are suppressed, whatever the threshold."""
    n = 140
    b = clumped(rng, n)
    bad = rng.rand(n) < 0.2
    b[bad, rng.randint(0, 6, int(bad.sum()))] = np.nan
    b[3] = b[0]
    b[3, 2] = np.nan
    return b, rng.rand(n).astype(F32), rng.rand(n) > 0.1, (0.3, -0.1)


SCAN_CASES = {
    "n1": case_sizes(1),
    "n63": case_sizes(63),
    "n64": case_sizes(64),
    "n65": case_sizes(65),
    "n127": case_sizes(127),
    "n129": case_sizes(129),
    "block_edges": case_block_edges,
    "block_suppressed": case_block_suppressed,
    "invalid_suppressors": case_invalid_suppressors,
    "all_invalid": case_all_invalid,
    "identical": case_identical,
    "tied_scores": case_tied_scores,
    "thr_at_least_one": case_thr_at_least_one,
    "thr_negative": case_thr_negative,
    "nan_coordinates": case_nan_coordinates,
}


def make_scan_case(name):
    """``(boxes [N, 6] float32, scores [N] float32, valid [N] bool, thrs)``
    of a named case, seeded by its name."""
    return SCAN_CASES[name](np.random.RandomState(len(name) * 1000 + sum(map(ord, name))))


def ranked(boxes, scores, valid):
    """The boxes in the order ``nms_mask`` ranks them (score, then index;
    invalid rows last) and their valid flags: the kernels' inputs."""
    masked = np.where(valid, scores, F32(-np.inf))
    order = np.argsort(-masked, kind="stable")
    return order, boxes[order], np.isfinite(masked[order])


# ---------------------------------------------------------------- checks
def check_case(boxes, scores, valid, thr, with_jax=True):
    """Both models against the plain versions, on the rows in their given
    order (invalid rows anywhere) and ranked as ``nms_mask`` ranks them; the
    ranked result against the JAX ``nms_mask`` and the port's. Returns the
    keep mask."""
    n = len(boxes)
    for b, v in ((boxes, valid), ranked(boxes, scores, valid)[1:]):
        plain = suppression_matrix_plain(torch.from_numpy(b), thr)
        got = model_words(b, thr)
        assert (got == to_u64(plain)).all()
        keep = model_keep_scan(got, v)
        np.testing.assert_array_equal(keep, nms_keep_scan_plain(plain, torch.from_numpy(v)).numpy())
    order = ranked(boxes, scores, valid)[0]
    mask = np.zeros(n, bool)
    mask[order] = keep
    port = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
                    thr).numpy()
    np.testing.assert_array_equal(mask, port)
    if with_jax:
        import jax.numpy as jnp

        from nndetection_tpu.core.boxes import nms as jax_nms

        want = np.asarray(jax_nms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                           jnp.asarray(valid), thr))
        np.testing.assert_array_equal(mask, want)
    return mask


def test_model_reads_the_kernel_source():
    assert GEO["kBits"] == BITS and GEO["kTileThreads"] % 32 == 0
    assert BITS % TILE_WARPS == 0 and GEO["kScanThreads"] > 32


@pytest.mark.parametrize("t", [0, 1, 2, 3, 5, 6, 135, 2079, 2080, 32895, 422_000_000])
def test_upper_tile_decodes_every_tile(t):
    r, c = upper_tile(t)
    assert 0 <= r <= c and c * (c + 1) // 2 + r == t


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_model_of_the_kernels_equals_plain_and_jax(name):
    boxes, scores, valid, thrs = make_scan_case(name)
    for thr in thrs:
        keep = check_case(boxes, scores, valid, thr)
        idx = np.nonzero(valid)[0]
        if name == "block_edges":
            assert keep[63] and not keep[64] and keep[65] and keep[5]
            assert not keep[130] and not keep[140]
        elif name == "block_suppressed":
            assert keep[:64].all() and not keep[64:128].any() and keep[128:].all()
        elif name == "invalid_suppressors":
            np.testing.assert_array_equal(keep, valid)
        elif name == "all_invalid":
            assert not keep.any()
        elif name == "identical":
            assert keep.sum() == 1 and keep[idx[np.argmax(scores[idx])]]
        elif name == "thr_at_least_one":
            np.testing.assert_array_equal(keep, valid)
        elif name == "thr_negative":
            assert keep.sum() == 1
        elif name == "nan_coordinates":
            assert keep[valid & ~np.isfinite(boxes).all(1)].all()


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 200),
       clumps=st.sampled_from([2, 6, 30]), ties=st.sampled_from([0, 3]),
       invalid=st.sampled_from([0.0, 0.1, 0.5, 1.0]), nan=st.sampled_from([0.0, 0.1]),
       thr=st.sampled_from([-0.1, 0.0, 0.1, 0.3, 0.7, 1.0]))
def test_model_of_the_kernels_equals_plain_and_jax_drawn(seed, n, clumps, ties, invalid, nan,
                                                         thr):
    rng = np.random.RandomState(seed)
    boxes = clumped(rng, n, clumps)
    boxes[rng.rand(n) < nan, rng.randint(0, 6)] = np.nan
    scores = rng.rand(n).astype(F32)
    if ties:
        scores = (np.floor(scores * ties) / ties).astype(F32)
    check_case(boxes, scores, rng.rand(n) >= invalid, thr)
