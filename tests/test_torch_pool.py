"""The port's device patch pool against the JAX package's ``DevicePatchPool``
(on JAX's CPU backend) and against the port's host ``PatchLoader``, both
pools on the CPU: the same batches bit for bit (cases smaller than the patch
padded with -1 in the pool's segmentation, and origins clamped as
``lax.dynamic_slice`` clamps them), batches that are copies and not views of
the pool, the sampling report and pool size, the swap schedule and the
boundary ``refresh`` and the in-epoch rotation policy against the JAX pool,
and rotation invariants that hold whatever the staging thread's timing."""
import threading

import numpy as np
import pytest
import torch

from nndetection_tpu.data import loader as jloader
from nndetection_tpu_torch.data import loader as tloader
from tests.test_torch_loader import SHAPES_3D, assert_same_batch, write_cases

torch.set_num_threads(1)

# generator patch (24, 28, 28): every case is smaller than it on some axis
KW = dict(patch_size=(24, 28, 28), batch_size=5, oversample_foreground_percent=0.5,
          max_instances=6, seed=11, inner_patch_size=(16, 16, 16))


def pools(tmp_path, shapes=SHAPES_3D, channels=2, **kw):
    write_cases(tmp_path, shapes, channels=channels)
    kw = {**KW, **kw}
    jp = jloader.DevicePatchPool(jloader.build_case_records(tmp_path), **kw)
    tp = tloader.DevicePatchPool(tloader.build_case_records(tmp_path), device="cpu", **kw)
    return tp, jp


def test_pool_matches_jax_pool_and_host_loader(tmp_path):
    tp, jp = pools(tmp_path)
    host = tloader.PatchLoader(tloader.build_case_records(tmp_path), **KW)
    assert tp.max_shape == jp.max_shape == (26, 30, 30)
    assert [r.case_id for r in tp._pool_slots] == [r.case_id for r in jp._pool_slots]
    padded = 0
    for _ in range(4):
        got, want, h = tp.generate_batch(), jp.generate_batch(), host.generate_batch()
        assert got["images"].device.type == "cpu"
        assert tuple(got["images"].shape) == (5, 24, 28, 28, 2)
        assert_same_batch(got, {k: np.asarray(v) for k, v in want.items()})
        # the host loader pads the segmentation with 0 where the pool pads -1
        seg = got["seg_instances"]
        padded += int((seg == -1).sum())
        assert torch.equal(torch.where(seg == -1, torch.zeros_like(seg), seg),
                           h["seg_instances"])
        assert torch.equal(got["images"], h["images"])
        assert torch.equal(got["instance_classes"], h["instance_classes"])
    assert padded > 0
    assert tp.rng.randint(1 << 30) == jp.rng.randint(1 << 30) == host.rng.randint(1 << 30)


def test_clamped_origins_match_jax(tmp_path):
    """Origins below 0 (counted from the end of the axis) and beyond
    ``max_shape - patch`` clamp as ``lax.dynamic_slice`` clamps them, on
    every axis and at the edges."""
    tp, jp = pools(tmp_path)
    hi = np.asarray(tp.max_shape) - np.asarray(tp.patch_size)
    origins = np.array([[-3, 0, 7], hi, hi + 1, [50, -9, 1], [1, 2, 100]], np.int32)
    case_idx = np.array([0, 1, 1, 3, 2], np.int32)
    got_d, got_s = tp.gather(case_idx.tolist(), origins)
    want_d, want_s = jp._gather(jp._data_pool, jp._seg_pool, case_idx, origins)
    np.testing.assert_array_equal(got_d.view(torch.int16).numpy(),
                                  np.asarray(want_d).view(np.int16))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the clamped patch is the one at the clamped origin
    np.testing.assert_array_equal(got_s[2].numpy(), got_s[1].numpy())


def test_batches_are_not_views_of_the_pool(tmp_path):
    tp, _ = pools(tmp_path)
    batch = tp.generate_batch()
    kept = {k: v.clone() for k, v in batch.items()}
    for key, pool in (("images", tp._data_pool), ("seg_instances", tp._seg_pool)):
        assert batch[key].untyped_storage().data_ptr() != pool.untyped_storage().data_ptr()
    # overwrite every slot in place, as a swap does
    for slot in range(len(tp._pool_slots)):
        rec = tp._pool_slots[slot]
        data, seg = tp._case_arrays(rec)
        tp._put(slot, torch.full_like(data, 7.0), torch.full_like(seg, 3))
    assert all(torch.equal(batch[k], kept[k]) for k in batch)
    assert (tp._data_pool == 7.0).all()


def test_sampling_report_and_pool_bytes_match_jax(tmp_path):
    tp, jp = pools(tmp_path)
    list(tp.epoch(3))
    list(jp.epoch(3))
    assert tp.sampling_report() == jp.sampling_report()
    assert tp.pool_bytes() == jp.pool_bytes() == 4 * 26 * 30 * 30 * (2 * 2 + 2)
    assert tp.sampling_report()["pool_coverage"] == 1.0


def test_cases_are_stored_as_the_jax_pool_stores_them(tmp_path):
    """Data rounded to bfloat16 (nearest even), ids as int16, padded with 0
    and -1 to ``max_shape``, channel-last."""
    tp, jp = pools(tmp_path)
    np.testing.assert_array_equal(tp._data_pool.view(torch.int16).numpy(),
                                  np.asarray(jp._data_pool).view(np.int16))
    np.testing.assert_array_equal(tp._seg_pool.numpy(), np.asarray(jp._seg_pool))


@pytest.mark.parametrize("hint,budget", [(4, 8 * 1024**3), (1, 8 * 1024**3), (1, 1), (None, 1)])
def test_swap_schedule_and_refresh_match_jax(tmp_path, hint, budget):
    """A pool of 3 slots over 8 cases: the same swap rate, the same initial
    slots and, after each boundary ``refresh``, the same resident cases and
    pool contents as the JAX pool."""
    tp, jp = pools(tmp_path, shapes=SHAPES_3D * 2, channels=1, max_pool_cases=3,
                   swap_per_epoch=1, num_epochs_hint=hint, max_swap_bytes_per_epoch=budget)
    assert tp.swap_per_epoch == jp.swap_per_epoch
    for _ in range(4):
        assert [r.case_id for r in tp._pool_slots] == [r.case_id for r in jp._pool_slots]
        np.testing.assert_array_equal(tp._seg_pool.numpy(), np.asarray(jp._seg_pool))
        for _ in range(2):
            assert_same_batch(tp.generate_batch(),
                              {k: np.asarray(v) for k, v in jp.generate_batch().items()})
        tp.refresh()
        jp.refresh()
    assert tp.sampling_report() == jp.sampling_report()


def test_rotation_invariants(tmp_path):
    """One epoch of in-epoch rotation over 12 cases behind 3 slots. Whatever
    the staging thread's timing: every rotation brings in a case that was
    never resident, each slot holds the data of the case it names, the
    slots stay distinct, and the report counts what happened."""
    write_cases(tmp_path, [(10 + i % 5, 12, 11 + i % 3) for i in range(12)], seed=2)
    records = tloader.build_case_records(tmp_path)
    pool = tloader.DevicePatchPool(records, patch_size=(8, 8, 8), batch_size=2,
                                   max_pool_cases=3, seed=0, device="cpu")
    first = {r.case_id for r in pool._pool_slots}
    batches = list(pool.epoch(30))
    rep = pool.sampling_report()
    assert len(batches) == 30 and all(b["images"].shape == (2, 8, 8, 8, 1) for b in batches)
    ids = [r.case_id for r in pool._pool_slots]
    assert len(ids) == len(set(ids)) == 3
    assert first <= pool._ever_resident
    assert len(pool._ever_resident) == 3 + rep["pool_rotations_last_epoch"]
    assert rep["pool_coverage"] == len(pool._ever_resident) / 12
    assert 0 <= rep["pool_rotations_last_epoch"] <= 9
    assert sum(pool._visits.values()) == 60
    for slot, rec in enumerate(pool._pool_slots):
        data, seg = pool._case_arrays(rec)
        assert torch.equal(pool._data_pool[slot], data) and torch.equal(pool._seg_pool[slot], seg)


def test_rotation_policy_matches_jax(tmp_path):
    """The rotation plan (outsiders least visited first, ties broken by the
    pool's RNG, capped by the transfer budget) and each swap's eviction (the
    most visited resident) are the JAX pool's, driven by hand so that no
    staging thread is involved."""
    tp, jp = pools(tmp_path, shapes=SHAPES_3D * 2, channels=1, max_pool_cases=3)
    for _ in range(3):
        assert_same_batch(tp.generate_batch(),
                          {k: np.asarray(v) for k, v in jp.generate_batch().items()})
    got, want = tp._rotation_plan(), jp._rotation_plan()
    assert [r.case_id for r in got] == [r.case_id for r in want] and len(got) == 5
    for rec_t, rec_j in zip(got[:3], want[:3]):
        tp._swap_slot(rec_t, *tp._case_arrays(rec_t))
        jp._swap_slot(rec_j, *jp._case_arrays(rec_j))
        assert [r.case_id for r in tp._pool_slots] == [r.case_id for r in jp._pool_slots]
        assert_same_batch(tp.generate_batch(),
                          {k: np.asarray(v) for k, v in jp.generate_batch().items()})
    np.testing.assert_array_equal(tp._seg_pool.numpy(), np.asarray(jp._seg_pool))
    assert tp.sampling_report() == jp.sampling_report()


def test_rotation_starved_then_drained(tmp_path, monkeypatch):
    """A stager held back until the batch loop has ended: every due swap
    finds nothing staged and is counted as starved, the epoch still yields
    all its batches, and the drain at its end leaves consistent slots."""
    write_cases(tmp_path, [(10 + i % 5, 12, 11) for i in range(6)], seed=3)
    pool = tloader.DevicePatchPool(tloader.build_case_records(tmp_path), patch_size=(8, 8, 8),
                                   batch_size=2, max_pool_cases=2, seed=1, device="cpu")
    gate = threading.Event()
    stage = pool._case_arrays

    def held(rec):
        gate.wait(timeout=60)
        return stage(rec)

    monkeypatch.setattr(pool, "_case_arrays", held)
    it = pool.epoch(5)
    batches = [next(it) for _ in range(5)]
    assert pool._io_starved_last_epoch >= 1 and pool._rotations_last_epoch == 0
    gate.set()
    assert list(it) == []
    assert len(batches) == 5
    assert 0 <= pool._rotations_last_epoch <= 4
    assert len(pool._ever_resident) == 2 + pool._rotations_last_epoch
    for slot, rec in enumerate(pool._pool_slots):
        data, seg = stage(rec)
        assert torch.equal(pool._data_pool[slot], data) and torch.equal(pool._seg_pool[slot], seg)


def test_pool_on_a_missing_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    write_cases(tmp_path, SHAPES_3D)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloader.DevicePatchPool(tloader.build_case_records(tmp_path), **KW)
