"""Greedy top-k NMS of the PyTorch port (``ops/nms.py`` and
``core/boxes/nms.py``) against the JAX package: ``nms_topk_pallas`` in
interpret mode and the lax ``topk_nms``, index for index. On the CPU the port
runs its plain version; the CUDA kernel is held to it on the card (``cuda``
marker and ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nndetection_tpu.core.boxes.nms import batched_nms_topk as jax_batched_nms_topk
from nndetection_tpu.core.boxes.nms import topk_nms as jax_topk_nms
from nndetection_tpu.ops.pallas_ops import nms_topk_pallas
from nndetection_tpu_torch.core.boxes.nms import batched_nms_topk, topk_nms
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops.nms import nms_topk, nms_topk_plain

torch.set_num_threads(1)


def random_boxes(rng, n):
    ctr = rng.uniform(10, 90, (n, 3))
    sz = rng.uniform(2, 25, (n, 3))
    return np.stack([
        ctr[:, 0] - sz[:, 0], ctr[:, 1] - sz[:, 1],
        ctr[:, 0] + sz[:, 0], ctr[:, 1] + sz[:, 1],
        ctr[:, 2] - sz[:, 2], ctr[:, 2] + sz[:, 2],
    ], axis=1).astype(np.float32)


def _pallas(boxes, scores, valid, thr, max_out):
    """The Pallas kernel as ``topk_nms`` calls it: min(max_out, N) steps,
    padded with index 0, invalid."""
    n = len(boxes)
    idx, keep = nms_topk_pallas(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                                thr, min(max_out, n), interpret=True)
    idx, keep = np.asarray(idx), np.asarray(keep)
    pad = max_out - len(idx)
    return np.pad(idx, (0, pad)), np.pad(keep, (0, pad))


def _port(boxes, scores, valid, thr, max_out):
    idx, keep = topk_nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                         torch.from_numpy(valid)[None], thr, max_out)
    return idx[0].numpy(), keep[0].numpy()


@pytest.mark.parametrize("n,max_out", [
    (1, 1), (1, 5), (7, 3), (7, 10), (300, 100), (300, 400), (1000, 100), (1000, 1200),
])
def test_matches_pallas_and_lax(n, max_out):
    rng = np.random.RandomState(n + max_out)
    boxes = random_boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.1
    for thr in (0.1, 0.5):
        got_idx, got_valid = _port(boxes, scores, valid, thr, max_out)
        p_idx, p_valid = _pallas(boxes, scores, valid, thr, max_out)
        l_idx, l_valid = jax_topk_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(valid), thr, max_out)
        np.testing.assert_array_equal(got_valid, p_valid)
        np.testing.assert_array_equal(got_idx, p_idx)
        np.testing.assert_array_equal(got_valid, np.asarray(l_valid))
        np.testing.assert_array_equal(got_idx, np.asarray(l_idx))
        assert got_valid.sum() > 0 or not valid.any()


def test_all_invalid():
    boxes = random_boxes(np.random.RandomState(0), 16)
    got_idx, got_valid = _port(boxes, np.zeros(16, np.float32), np.zeros(16, bool), 0.5, 8)
    p_idx, p_valid = _pallas(boxes, np.zeros(16, np.float32), np.zeros(16, bool), 0.5, 8)
    assert not got_valid.any()
    np.testing.assert_array_equal(got_idx, np.zeros(8))
    np.testing.assert_array_equal(got_idx, p_idx)
    np.testing.assert_array_equal(got_valid, p_valid)


@pytest.mark.parametrize("thr", [0.0, 0.3, 0.6])
def test_tied_scores_take_the_lowest_index(thr):
    """Scores from five levels: every step breaks ties by lowest index."""
    rng = np.random.RandomState(11)
    n = 200
    boxes = random_boxes(rng, n)
    scores = (rng.randint(0, 5, n) / 5.0).astype(np.float32)
    valid = np.ones(n, bool)
    got_idx, got_valid = _port(boxes, scores, valid, thr, 60)
    p_idx, p_valid = _pallas(boxes, scores, valid, thr, 60)
    np.testing.assert_array_equal(got_idx, p_idx)
    np.testing.assert_array_equal(got_valid, p_valid)
    # identical boxes: only the first of each tied group survives
    dup = np.repeat(boxes[:3], 4, axis=0)
    got_idx, got_valid = _port(dup, np.ones(12, np.float32), np.ones(12, bool), thr, 12)
    np.testing.assert_array_equal(got_idx[got_valid], [0, 4, 8][: got_valid.sum()])


def test_images_batched_in_one_call():
    rng = np.random.RandomState(4)
    n_img, n = 5, 120
    boxes = np.stack([random_boxes(rng, n) for _ in range(n_img)])
    scores = rng.rand(n_img, n).astype(np.float32)
    valid = rng.rand(n_img, n) > 0.2
    idx, keep = topk_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(valid), 0.4, 30)
    for i in range(n_img):
        p_idx, p_valid = _pallas(boxes[i], scores[i], valid[i], 0.4, 30)
        np.testing.assert_array_equal(idx[i].numpy(), p_idx)
        np.testing.assert_array_equal(keep[i].numpy(), p_valid)


def test_class_batched_matches_jax():
    rng = np.random.RandomState(5)
    n_img, n = 3, 150
    boxes = np.stack([random_boxes(rng, n) for _ in range(n_img)])
    scores = rng.rand(n_img, n).astype(np.float32)
    labels = rng.randint(0, 3, (n_img, n)).astype(np.int32)
    valid = rng.rand(n_img, n) > 0.1
    idx, keep = batched_nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores),
                                 torch.from_numpy(labels), torch.from_numpy(valid), 0.3, 50)
    for i in range(n_img):
        j_idx, j_valid = jax_batched_nms_topk(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(labels[i]),
            jnp.asarray(valid[i]), 0.3, 50)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(j_valid))


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(6)
    boxes = torch.from_numpy(random_boxes(rng, 50))[None]
    scores = torch.from_numpy(rng.rand(1, 50).astype(np.float32))
    before = dict(LAUNCHES)
    idx, keep = nms_topk(boxes, scores, 0.5, 10)
    p_idx, p_keep = nms_topk_plain(boxes, scores, 0.5, 10)
    assert dict(LAUNCHES) == before
    np.testing.assert_array_equal(idx.numpy(), p_idx.numpy())
    np.testing.assert_array_equal(keep.numpy(), p_keep.numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_img,n,max_out", [(16, 1000, 100), (2, 10000, 100), (3, 7, 10)])
def test_cuda_kernel_matches_plain(cuda_device, n_img, n, max_out):
    rng = np.random.RandomState(n)
    boxes = torch.from_numpy(np.stack([random_boxes(rng, n) for _ in range(n_img)]))
    scores = torch.from_numpy(rng.rand(n_img, n).astype(np.float32))
    scores[torch.from_numpy(rng.rand(n_img, n) < 0.1)] = float("-inf")
    boxes, scores = boxes.to(cuda_device), scores.to(cuda_device)
    n0 = LAUNCHES["nms_topk"]
    idx, keep = nms_topk(boxes, scores, 0.5, max_out)
    p_idx, p_keep = nms_topk_plain(boxes, scores, 0.5, min(max_out, n))
    torch.cuda.synchronize()
    assert LAUNCHES["nms_topk"] == n0 + 1
    steps = min(max_out, n)
    assert torch.equal(idx[:, :steps], p_idx.long())
    assert torch.equal(keep[:, :steps], p_keep)
