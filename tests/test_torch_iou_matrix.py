"""Pairwise IoU of the PyTorch port (``ops/iou_matrix.py``, kernel #6)
against the JAX package: ``iou_matrix_pallas`` in interpret mode and
``box_iou``. On the CPU the port runs its plain version; the CUDA kernel is
held to it on the card (``cuda`` marker and ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nndetection_tpu.core.boxes.ops import box_iou
from nndetection_tpu.ops.pallas_ops import iou_matrix_pallas
from nndetection_tpu_torch.ops import LAUNCHES
from nndetection_tpu_torch.ops.iou_matrix import iou_matrix, iou_matrix_plain
from tests.test_torch_nms import random_boxes

torch.set_num_threads(1)

# as tests/test_pallas_ops.py holds the Pallas kernel to box_iou
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,m", [(100, 70), (13, 300), (257, 513)])
def test_matches_pallas_and_box_iou(n, m):
    rng = np.random.RandomState(n * m)
    b1, b2 = random_boxes(rng, n), random_boxes(rng, m)
    # overlapping pairs at every size: half of b2 are jittered copies of b1
    k = min(n, m) // 2
    b2[:k] = b1[:k] + rng.uniform(-3, 3, (k, 6)).astype(np.float32)
    b2[:k, 2:4] = np.maximum(b2[:k, 2:4], b2[:k, 0:2] + 1)
    b2[:k, 5] = np.maximum(b2[:k, 5], b2[:k, 4] + 1)
    got = iou_matrix(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    pallas = np.asarray(iou_matrix_pallas(jnp.asarray(b1), jnp.asarray(b2), interpret=True))
    ref = np.asarray(box_iou(jnp.asarray(b1), jnp.asarray(b2)))
    assert got.shape == (n, m) and got.dtype == np.float32
    assert (got > 0.1).sum() >= k
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_zero_volume_pairs_give_zero():
    """Two zero-volume boxes: the port clamps the union as the Pallas kernel
    does (IoU 0), where ``box_iou`` divides 0 by 0."""
    rng = np.random.RandomState(3)
    b = random_boxes(rng, 12)
    b[3:6] = 0.0  # zero padding
    b[7, 2] = b[7, 0]  # a flat box
    got = iou_matrix(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    pallas = np.asarray(iou_matrix_pallas(jnp.asarray(b), jnp.asarray(b), interpret=True))
    ref = np.asarray(box_iou(jnp.asarray(b), jnp.asarray(b)))
    flat = [3, 4, 5, 7]
    assert np.isnan(ref[np.ix_(flat, flat)]).all()
    np.testing.assert_array_equal(got[np.ix_(flat, flat)], 0.0)
    np.testing.assert_allclose(got, pallas, **TOL)
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], **TOL)


def test_empty_and_cpu_take_the_plain_version():
    rng = np.random.RandomState(4)
    b1, b2 = torch.from_numpy(random_boxes(rng, 9)), torch.from_numpy(random_boxes(rng, 5))
    before = dict(LAUNCHES)
    assert torch.equal(iou_matrix(b1, b2), iou_matrix_plain(b1, b2))
    assert iou_matrix(b1[:0], b2).shape == (0, 5)
    assert dict(LAUNCHES) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,kind", [(1000, 1000, "spread"), (33, 70, "spread"),
                                      (1, 1, "spread"), (1000, 1001, "spread"),
                                      (4097, 4093, "spread"), (1000, 1000, "dense"),
                                      (4097, 4093, "dense")])
def test_cuda_kernel_bit_equal_to_plain(cuda_device, n, m, kind):
    """The kernel against its plain version on the card: NaN at the same
    positions (none here) and the same bits everywhere, on spread boxes
    (most pairs apart: the division skipped) and on one dense clump (every
    pair meets), with 16-byte stores (``M % 4 == 0``) and without."""
    rng = np.random.RandomState(n + m)
    make = random_boxes if kind == "spread" else chip_smoke.dense_boxes
    b1 = torch.from_numpy(make(rng, n)).to(cuda_device)
    b2 = torch.from_numpy(make(rng, m)).to(cuda_device)
    n0 = LAUNCHES["iou_matrix"]
    got = iou_matrix(b1, b2)
    want = iou_matrix_plain(b1, b2)
    torch.cuda.synchronize()
    assert LAUNCHES["iou_matrix"] == n0 + 1
    assert chip_smoke.same_bits(got, want)
    if kind == "dense":
        assert bool((want > 0).all())
