"""The port's host loaders against the JAX package's on the same files and
seed: case records, the three patch loaders (the same crops, the same
bfloat16 bits, segmentation and class tables, and the same generator state
after), validation's fixed sequence, the padding of cases smaller than the
patch, ``PrefetchIterator`` (order, and a worker's error raised in the
consumer), and ``make_splits`` / ``build_loaders`` (whose ``device_pool=True``
builds the device patch pool, on the CPU too: ``test_torch_pool.py``)."""
import types

import numpy as np
import pytest
import torch

from nndetection_tpu import pipeline as jpipeline
from nndetection_tpu.data import loader as jloader
from nndetection_tpu_torch import pipeline as tpipeline
from nndetection_tpu_torch.data import augment as TA
from nndetection_tpu_torch.data import aug_presets as TP
from nndetection_tpu_torch.data import loader as tloader
from nndetection_tpu_torch.utils.io import save_pickle

torch.set_num_threads(1)

SHAPES_3D = [(20, 24, 22), (10, 12, 30), (26, 18, 20), (14, 30, 16)]


def write_cases(root, shapes, seed=0, channels=1, classes=2):
    """Preprocessed cases in the loaders' format: ``{case}.npy`` float32
    ``[channels + 1, *shape]`` (the last channel instance ids) and
    ``{case}_boxes.pkl`` (boxes (x1, y1, x2, y2[, z1, z2]) over axes 0, 1
    (and 2), upper bounds exclusive, classes, instance ids). Case 1 has no
    instance."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    for c, shape in enumerate(shapes):
        dim = len(shape)
        arr = np.zeros((channels + 1, *shape), np.float32)
        arr[:channels] = rng.standard_normal((channels, *shape))
        boxes, cls, ids = [], [], []
        for iid in range(1, 0 if c == 1 else rng.randint(2, 5)):
            ext = [rng.randint(2, max(3, s // 3)) for s in shape]
            lo = [rng.randint(0, s - e + 1) for s, e in zip(shape, ext)]
            arr[(channels,) + tuple(slice(l, l + e) for l, e in zip(lo, ext))] = iid
            hi = [l + e for l, e in zip(lo, ext)]
            box = [lo[0], lo[1], hi[0], hi[1]] + ([lo[2], hi[2]] if dim == 3 else [])
            boxes.append(box)
            cls.append(rng.randint(classes))
            ids.append(iid)
        np.save(root / f"case_{c:03d}.npy", arr)
        save_pickle({"boxes": np.asarray(boxes, np.float32).reshape(-1, 2 * dim),
                     "classes": np.asarray(cls, np.int64),
                     "instance_ids": np.asarray(ids, np.int64)},
                    root / f"case_{c:03d}_boxes.pkl")
    return root


def assert_same_batch(got, want):
    assert got["images"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["images"].view(torch.int16).numpy(),
                                  want["images"].view(np.int16))
    assert got["seg_instances"].dtype == torch.int16
    np.testing.assert_array_equal(got["seg_instances"].numpy(), want["seg_instances"])
    assert got["instance_classes"].dtype == torch.int32
    np.testing.assert_array_equal(got["instance_classes"].numpy(), want["instance_classes"])


def test_case_records(tmp_path):
    write_cases(tmp_path, SHAPES_3D)
    got, want = tloader.build_case_records(tmp_path), jloader.build_case_records(tmp_path)
    assert len(got) == len(want) == len(SHAPES_3D)
    for g, w in zip(got, want):
        assert (g.case_id, g.npy_path, g.shape) == (w.case_id, w.npy_path, w.shape)
        for f in ("boxes", "classes", "instance_ids"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            assert getattr(g, f).dtype == getattr(w, f).dtype


@pytest.mark.parametrize("kind", ["DataLoader3DOffset", "DataLoader3DBalanced",
                                  "DataLoader3DFast"])
@pytest.mark.parametrize("batch,oversample", [(5, 0.5), (4, 0.5), (5, 1 / 3)])  # round(2.5) == 2
def test_loaders_match_jax(tmp_path, kind, batch, oversample):
    """Generator patch (24, 28, 28) with the foreground constraint on the
    inner (16, 16, 16): cases smaller than the patch pad at the high end."""
    write_cases(tmp_path, SHAPES_3D, channels=2)
    kw = dict(patch_size=(24, 28, 28), batch_size=batch, oversample_foreground_percent=oversample,
              max_instances=6, seed=11, inner_patch_size=(16, 16, 16))
    jl = jloader.DATALOADER_REGISTRY[kind](jloader.build_case_records(tmp_path), **kw)
    tl = tloader.DATALOADER_REGISTRY[kind](tloader.build_case_records(tmp_path), **kw)
    for g, w in zip(tl.epoch(4), jl.epoch(4)):
        assert tuple(g["images"].shape) == (batch, 24, 28, 28, 2)
        assert_same_batch(g, w)
    assert tl.rng.randint(1 << 30) == jl.rng.randint(1 << 30)


def test_loader_2d_and_fixed_sequence(tmp_path):
    write_cases(tmp_path, [(20, 24), (10, 30), (26, 18)], seed=3)
    kw = dict(patch_size=(16, 16), batch_size=4, max_instances=4, seed=5, fixed_sequence=True)
    jl = jloader.PatchLoader(jloader.build_case_records(tmp_path), **kw)
    tl = tloader.PatchLoader(tloader.build_case_records(tmp_path), **kw)
    first = list(tl.epoch(2))
    for g, w in zip(first, jl.epoch(2)):
        assert_same_batch(g, w)
    for a, b in zip(first, tl.epoch(2)):  # every epoch replays the same patches
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_small_case_is_padded_with_background(tmp_path):
    write_cases(tmp_path, [(6, 8, 5)], seed=1)
    loader = tloader.PatchLoader(tloader.build_case_records(tmp_path), (8, 10, 12), 2)
    images, seg = loader.sample_patch(loader.records[0], force_fg=True)
    assert images.shape == (1, 8, 10, 12) and seg.shape == (8, 10, 12)
    raw = np.load(tmp_path / "case_000.npy")
    np.testing.assert_array_equal(images[:, :6, :8, :5], raw[:1])
    assert (images[:, 6:] == 0).all() and (seg[:, :, 5:] == 0).all()


def test_prefetch_iterator(tmp_path):
    assert list(tloader.PrefetchIterator(iter(range(7)), depth=2)) == list(range(7))

    def failing():
        yield 1
        yield 2
        raise ValueError("worker failed")

    it = tloader.PrefetchIterator(failing(), depth=1)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="worker failed"):
        next(it)
    it.thread.join(timeout=10)
    assert not it.thread.is_alive()


def test_prefetch_iterators_under_thread_switching():
    """Sixteen prefetch threads at once, switching every microsecond: each
    consumer gets its whole sequence, in order, and every thread ends."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        its = [tloader.PrefetchIterator(iter(range(i, i + 300)), depth=2) for i in range(16)]
        got = [[] for _ in its]
        for _ in range(300):
            for i, it in enumerate(its):
                got[i].append(next(it))
        for it in its:
            with pytest.raises(StopIteration):
                next(it)
            it.thread.join(timeout=10)
            assert not it.thread.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert got == [list(range(i, i + 300)) for i in range(16)]


def test_make_splits_matches_jax(tmp_path):
    ids = [f"case_{i:03d}" for i in (7, 3, 11, 0, 5, 9, 1, 2, 4, 6, 8, 10)]
    got = tpipeline.make_splits(ids, tmp_path / "t" / "splits_final.pkl")
    (tmp_path / "j").mkdir()
    want = jpipeline.make_splits(ids, tmp_path / "j" / "splits_final.pkl")
    assert got == want and len(got) == tpipeline.NUM_FOLDS
    # an existing file is read, not made again
    assert tpipeline.make_splits(["x"], tmp_path / "t" / "splits_final.pkl") == want


@pytest.mark.parametrize("augment,aug", [(True, "base_more"), (True, None), (False, None)])
def test_build_loaders_matches_jax(tmp_path, augment, aug):
    write_cases(tmp_path / "imagesTr", SHAPES_3D * 2, seed=4)
    plan = types.SimpleNamespace(patch_size=(8, 12, 12), max_instances_per_patch=5, in_channels=1)
    splits = tpipeline.make_splits([f"case_{i:03d}" for i in range(8)], tmp_path / "splits.pkl")
    cfg = TP.get_augmentation(aug, plan.patch_size) if aug else None
    jcfg = None
    if aug:
        from nndetection_tpu.data.aug_presets import get_augmentation
        jcfg = get_augmentation(aug, plan.patch_size)
    for fold in (0, -1):
        got = tpipeline.build_loaders(plan, tmp_path / "imagesTr", splits, fold, 2,
                                      augment=augment, seed=3, aug_cfg=cfg, device="cpu")
        want = jpipeline.build_loaders(plan, tmp_path / "imagesTr", splits, fold, 2,
                                       augment=augment, seed=3, aug_cfg=jcfg)
        for g, w in zip(got, want):
            assert type(w) is jloader.PatchLoader and not g.pin_memory
            assert [r.case_id for r in g.records] == [r.case_id for r in w.records]
            assert (g.patch_size, g.inner_patch, g.seed, g.fixed_sequence) == (
                w.patch_size, w.inner_patch, w.seed, w.fixed_sequence)
            assert_same_batch(g.generate_batch(), w.generate_batch())
    if augment:
        want_gen = TA.generator_patch_size_for(cfg) if cfg else TA.get_generator_patch_size(
            plan.patch_size)
        assert got[0].patch_size == want_gen and got[1].patch_size == plan.patch_size
    pool, _ = tpipeline.build_loaders(plan, tmp_path / "imagesTr", splits, 0, 2,
                                      device_pool=True, device="cpu")
    assert type(pool) is tloader.DevicePatchPool and pool.device.type == "cpu"
