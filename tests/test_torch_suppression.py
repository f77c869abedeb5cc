"""Untruncated greedy NMS of the PyTorch port (``ops/suppression.py``,
kernel #8 and the keep-scan; ``core/boxes/nms.py``: ``nms_mask``,
``batched_nms_mask``, ``weighted_nms_topk``) against the JAX package:
``suppression_matrix_pallas`` in interpret mode, bit for bit, and the JAX
NMS functions, exactly. On the CPU the port runs the plain versions; the
CUDA kernels are held to them on the card (``cuda`` marker and
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu.core.boxes import nms as jax_nms
from nndetection_tpu.core.boxes.ops_np import batched_nms_np, nms_np
from nndetection_tpu.ops.pallas_ops import suppression_matrix_pallas
from nndetection_tpu_torch.core.boxes.nms import batched_nms_mask, nms_mask, weighted_nms_topk
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops.suppression import (
    nms_keep_scan,
    nms_keep_scan_plain,
    pack_words,
    suppression_matrix,
    suppression_matrix_plain,
    unpack_words,
)
from tests.test_torch_nms import random_boxes

torch.set_num_threads(1)


def clustered_boxes(rng, n):
    """Random boxes, a third of them jittered copies of others, so that the
    relation has many set bits at every threshold."""
    b = random_boxes(rng, n)
    k = n // 3
    src = rng.randint(0, n - k, k)
    b[n - k:] = b[src] + rng.uniform(-2, 2, (k, 6)).astype(np.float32)
    b[n - k:, 2:4] = np.maximum(b[n - k:, 2:4], b[n - k:, 0:2] + 1)
    b[n - k:, 5] = np.maximum(b[n - k:, 5], b[n - k:, 4] + 1)
    return b


@pytest.mark.parametrize("n", [40, 300, 513])
def test_words_equal_pallas(n):
    rng = np.random.RandomState(n)
    boxes = clustered_boxes(rng, n)
    order = np.argsort(-rng.rand(n), kind="stable")
    sorted_boxes = boxes[order]
    for thr in (0.1, 0.3, 0.6):
        words = suppression_matrix(torch.from_numpy(sorted_boxes), thr)
        assert words.shape == (n, (n + 63) // 64) and words.dtype == torch.int64
        got = unpack_words(words, n).numpy()
        want = np.asarray(suppression_matrix_pallas(jnp.asarray(sorted_boxes), thr,
                                                    interpret=True)).astype(bool)
        assert want.sum() > n // 10
        np.testing.assert_array_equal(got, want)


def test_pack_unpack_round_trip():
    rng = np.random.RandomState(0)
    rel = torch.from_numpy(rng.rand(70, 130) > 0.5)
    rel[:, 63] = True  # the sign bit of a word
    words = pack_words(rel)
    assert words.shape == (70, 3)
    assert torch.equal(unpack_words(words, 130), rel)


def _jax_mask(fn, *arrays, thr):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), thr))


@pytest.mark.parametrize("n", [1, 7, 64, 65, 300])
def test_nms_mask_matches_jax_and_nms_np(n):
    rng = np.random.RandomState(n + 1)
    boxes = clustered_boxes(rng, n) if n > 3 else random_boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.15
    for thr in (0.0, 0.25, 0.5):
        got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(valid), thr).numpy()
        want = _jax_mask(jax_nms.nms_mask, boxes, scores, valid, thr=thr)
        np.testing.assert_array_equal(got, want)
        # the keep list of the host greedy NMS over the valid boxes
        idx = np.nonzero(valid)[0]
        order = np.argsort(-scores, kind="stable")
        ref = idx[nms_np(boxes[idx], scores[idx], thr)]
        assert [i for i in order if got[i]] == ref.tolist()


def test_nms_mask_tied_scores():
    """Equal scores rank by index, as ``jnp.argsort`` does."""
    rng = np.random.RandomState(9)
    n = 120
    boxes = clustered_boxes(rng, n)
    scores = (rng.randint(0, 4, n) / 4.0).astype(np.float32)
    valid = np.ones(n, bool)
    got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(valid), 0.2).numpy()
    np.testing.assert_array_equal(got, _jax_mask(jax_nms.nms_mask, boxes, scores, valid, thr=0.2))


@pytest.mark.parametrize("classes", [2, 3])
def test_batched_nms_mask_matches_jax(classes):
    rng = np.random.RandomState(classes)
    n = 250
    boxes = clustered_boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    labels = rng.randint(0, classes, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    for thr in (0.1, 0.4):
        got = batched_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                               torch.from_numpy(labels), torch.from_numpy(valid), thr).numpy()
        want = _jax_mask(jax_nms.batched_nms_mask, boxes, scores, labels, valid, thr=thr)
        np.testing.assert_array_equal(got, want)
        idx = np.nonzero(valid)[0]
        ref = idx[batched_nms_np(boxes[idx], scores[idx], labels[idx], thr)]
        assert sorted(np.nonzero(got)[0].tolist()) == sorted(ref.tolist())


@pytest.mark.parametrize("n,max_out", [(90, 20), (90, 120)])
def test_weighted_nms_topk_matches_jax(n, max_out):
    rng = np.random.RandomState(n + max_out)
    boxes = clustered_boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    weights = (0.5 + rng.rand(n)).astype(np.float32)
    valid = rng.rand(n) > 0.1
    idx, keep = weighted_nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores),
                                  torch.from_numpy(weights), torch.from_numpy(valid), 0.3, max_out)
    j_idx, j_keep = jax_nms.weighted_nms_topk(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(weights), jnp.asarray(valid),
        0.3, max_out)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


def test_empty_and_cpu_take_the_plain_version():
    rng = np.random.RandomState(5)
    boxes = torch.from_numpy(clustered_boxes(rng, 30))
    before = dict(LAUNCHES)
    words = suppression_matrix(boxes, 0.3)
    assert torch.equal(words, suppression_matrix_plain(boxes, 0.3))
    valid = torch.from_numpy(rng.rand(30) > 0.2)
    assert torch.equal(nms_keep_scan(words, valid), nms_keep_scan_plain(words, valid))
    assert nms_mask(boxes[:0], torch.zeros(0), torch.zeros(0, dtype=torch.bool), 0.5).shape == (0,)
    assert dict(LAUNCHES) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 4096])
def test_cuda_kernels_equal_plain(cuda_device, n):
    rng = np.random.RandomState(n)
    boxes = torch.from_numpy(clustered_boxes(rng, n) if n > 3 else random_boxes(rng, n))
    valid = torch.from_numpy(rng.rand(n) > 0.1)
    boxes, valid = boxes.to(cuda_device), valid.to(cuda_device)
    n0 = dict(LAUNCHES)
    words = suppression_matrix(boxes, 0.3)
    keep = nms_keep_scan(words, valid)
    want_words = suppression_matrix_plain(boxes, 0.3)
    torch.cuda.synchronize()
    assert LAUNCHES["suppression_matrix"] == n0.get("suppression_matrix", 0) + 1
    assert LAUNCHES["nms_keep_scan"] == n0.get("nms_keep_scan", 0) + 1
    assert torch.equal(words, want_words)
    assert torch.equal(keep, nms_keep_scan_plain(want_words, valid))
