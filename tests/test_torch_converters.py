"""The port's dataset conversion utilities against the JAX package's on the
same inputs: ``cli/convert.py`` (``seg2det``, ``cls2fg`` and the module's
command line), ``cli/nnunet_interop.py`` (``export_to_nnunet``,
``nnunet_seg_to_boxes``), ``data/prepare.py`` (class removal and
reordering, connected-component instances, ``instances_from_segmentation``,
``create_test_split``) and ``data/patching.py::save_get_crop`` in both
modes. Output trees are compared file by file: volumes as arrays with
their spacing and affine, JSON, YAML and pickles as parsed objects."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from nndetection_tpu.cli import convert as jconvert
from nndetection_tpu.cli import nnunet_interop as jinterop
from nndetection_tpu.data import nifti as jnifti
from nndetection_tpu.data import patching as jpatching
from nndetection_tpu.data import prepare as jprepare
from nndetection_tpu.utils.io import save_json, save_yaml
from nndetection_tpu_torch.cli import convert as tconvert
from nndetection_tpu_torch.cli import nnunet_interop as tinterop
from nndetection_tpu_torch.data import nifti as tnifti
from nndetection_tpu_torch.data import patching as tpatching
from nndetection_tpu_torch.data import prepare as tprepare
from tests.test_torch_prep import assert_same

REPO = Path(__file__).resolve().parents[1]


def assert_same_outputs(got_dir: Path, want_dir: Path, skip=(), parse=True):
    """The same relative file names under both directories, and each file
    the same: ``.nii.gz`` / ``.nii`` as (array, spacing, affine) bit for
    bit, ``.json``, ``.yaml``, ``.pkl`` and ``.npz`` as parsed objects,
    anything else (everything without ``parse``) byte for byte. Returns the
    files compared."""
    def files(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                      if p.is_file() and p.name not in skip)
    names = files(want_dir)
    assert files(got_dir) == names, (files(got_dir), names)
    for name in names:
        got, want = got_dir / name, want_dir / name
        if not parse:
            assert got.read_bytes() == want.read_bytes(), name
        elif name.endswith((".nii.gz", ".nii")):
            assert_same(tnifti.load(got), jnifti.load(want), name)
        elif name.endswith(".json"):
            assert json.loads(got.read_text()) == json.loads(want.read_text()), name
        elif name.endswith(".yaml"):
            assert yaml.safe_load(got.read_text()) == yaml.safe_load(want.read_text()), name
        elif name.endswith(".pkl"):
            import pickle

            assert_same(pickle.loads(got.read_bytes()), pickle.loads(want.read_bytes()), name)
        elif name.endswith(".npz"):
            with np.load(got) as g, np.load(want) as w:
                assert_same({k: g[k] for k in g.files}, {k: w[k] for k in w.files}, name)
        else:
            assert got.read_bytes() == want.read_bytes(), name
    return names


def make_semantic_task(root: Path, seed=0, with_ts=True):
    """A semantic-segmentation task (``tests/test_converters.py``): two
    classes, several components of different sizes, a test split."""
    rng = np.random.RandomState(seed)
    task = root / "TaskSem"
    for split in ("Tr", "Ts") if with_ts else ("Tr",):
        (task / "raw_splitted" / f"images{split}").mkdir(parents=True)
        (task / "raw_splitted" / f"labels{split}").mkdir(parents=True)
    save_yaml({"task": "TaskSem", "dim": 3, "labels": {"1": "a", "2": "b"},
               "modalities": {"0": "CT"}}, task / "dataset.yaml")
    for split, cases in (("Tr", ("c1", "c2")), ("Ts", ("c3",)) if with_ts else ("Tr", ())):
        for cid in cases:
            seg = np.zeros((16, 16, 16), np.int16)
            seg[2:5, 2:5, 2:5] = 1
            seg[8:11, 8:11, 8:11] = 1
            seg[12:14, 12:14, 12:14] = 2
            seg[0, 15, 15] = 2  # a one-voxel component
            seg[14:16, 0:2, 0:3] = 1
            nifti_aff = np.diag([0.8, 0.9, 2.0, 1.0])
            jnifti.save(task / "raw_splitted" / f"images{split}" / f"{cid}_0000.nii.gz",
                        rng.rand(16, 16, 16).astype(np.float32), np.asarray([2.0, 0.9, 0.8]),
                        nifti_aff)
            jnifti.save(task / "raw_splitted" / f"labels{split}" / f"{cid}.nii.gz", seg,
                        np.asarray([2.0, 0.9, 0.8]), nifti_aff)
    return task


def make_instance_task(root: Path, seed=0):
    rng = np.random.RandomState(seed)
    task = root / "TaskInst"
    (task / "raw_splitted" / "imagesTr").mkdir(parents=True)
    (task / "raw_splitted" / "labelsTr").mkdir(parents=True)
    save_yaml({"task": "TaskInst", "dim": 3, "labels": {"0": "a", "1": "b"},
               "modalities": {"0": "CT"}}, task / "dataset.yaml")
    for cid, classes in (("c1", {"1": 0, "2": 1}), ("c2", {"1": 1, "2": 1, "3": 0})):
        seg = np.zeros((12, 12, 12), np.int16)
        for i in range(1, len(classes) + 1):
            seg[3 * i - 2:3 * i, 1:4, 1:4] = i
        jnifti.save(task / "raw_splitted" / "imagesTr" / f"{cid}_0000.nii.gz",
                    rng.rand(12, 12, 12).astype(np.float32))
        jnifti.save(task / "raw_splitted" / "labelsTr" / f"{cid}.nii.gz", seg)
        save_json({"instances": classes}, task / "raw_splitted" / "labelsTr" / f"{cid}.json")
    return task


# ----------------------------------------------------------------- cli/convert.py
@pytest.mark.parametrize("min_size", [0.0, 4.0])
def test_seg2det(tmp_path, min_size):
    task = make_semantic_task(tmp_path)
    tconvert.seg2det(task, tmp_path / "t" / "TaskDet", min_size)
    jconvert.seg2det(task, tmp_path / "j" / "TaskDet", min_size)
    names = assert_same_outputs(tmp_path / "t" / "TaskDet", tmp_path / "j" / "TaskDet")
    assert "raw_splitted/labelsTs/c3.json" in names
    inst = json.loads((tmp_path / "t" / "TaskDet" / "raw_splitted" / "labelsTr" / "c1.json")
                      .read_text())["instances"]
    assert len(inst) == (5 if min_size == 0 else 4)


def test_cls2fg(tmp_path):
    task = make_instance_task(tmp_path)
    tconvert.cls2fg(task, tmp_path / "t" / "TaskFg")
    jconvert.cls2fg(task, tmp_path / "j" / "TaskFg")
    assert_same_outputs(tmp_path / "t" / "TaskFg", tmp_path / "j" / "TaskFg")
    meta = json.loads((tmp_path / "t" / "TaskFg" / "raw_splitted" / "labelsTr" / "c2.json")
                      .read_text())
    assert meta["instances"] == {"1": 0, "2": 0, "3": 0}
    assert meta["original_classes"] == {"1": 1, "2": 1, "3": 0}


def test_convert_command_line(tmp_path):
    """``python -m nndetection_tpu_torch.cli.convert seg2det`` writes what
    the JAX package's ``seg2det`` writes; an unknown command exits non-zero."""
    task = make_semantic_task(tmp_path, with_ts=False)
    proc = subprocess.run([sys.executable, "-m", "nndetection_tpu_torch.cli.convert", "seg2det",
                           str(task), str(tmp_path / "t" / "TaskDet"), "--min_size", "2"],
                          capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    jconvert.seg2det(task, tmp_path / "j" / "TaskDet", 2.0)
    assert_same_outputs(tmp_path / "t" / "TaskDet", tmp_path / "j" / "TaskDet")
    proc = subprocess.run([sys.executable, "-m", "nndetection_tpu_torch.cli.convert", "nope"],
                          capture_output=True, text=True, cwd=REPO)
    assert proc.returncode != 0 and "unknown command" in proc.stderr


# ----------------------------------------------------------------- cli/nnunet_interop.py
def test_export_to_nnunet(tmp_path, capsys):
    task = make_instance_task(tmp_path)
    tinterop.export_to_nnunet(task, tmp_path / "t")
    jinterop.export_to_nnunet(task, tmp_path / "j")
    assert_same_outputs(tmp_path / "t", tmp_path / "j")
    sem, _, _ = tnifti.load(tmp_path / "t" / "labelsTr" / "c2.nii.gz")
    assert set(np.unique(sem)) == {0, 1, 2}


@pytest.mark.parametrize("softmax, min_size", [(False, 0.0), (True, 0.0), (True, 10.0)])
def test_nnunet_seg_to_boxes(tmp_path, softmax, min_size):
    rng = np.random.RandomState(5)
    pred = tmp_path / "preds"
    pred.mkdir()
    for cid in ("c1", "c2"):
        seg = np.zeros((12, 12, 12), np.int16)
        seg[2:5, 2:5, 2:5] = 1
        seg[7:9, 7:10, 1:3] = 2
        seg[10, 10, 10] = 1
        jnifti.save(pred / f"{cid}.nii.gz", seg)
        if softmax:
            np.savez(pred / f"{cid}.npz", softmax=rng.rand(3, 12, 12, 12).astype(np.float32))
    tinterop.nnunet_seg_to_boxes(pred, tmp_path / "t", min_size)
    jinterop.nnunet_seg_to_boxes(pred, tmp_path / "j", min_size)
    assert_same_outputs(tmp_path / "t", tmp_path / "j")


# ----------------------------------------------------------------- data/prepare.py
def random_seg(seed, shape=(10, 12, 14), classes=4):
    rng = np.random.RandomState(seed)
    seg = np.zeros(shape, np.int32)
    for _ in range(8):
        lo = [rng.randint(0, s - 3) for s in shape]
        ext = [rng.randint(1, 4) for _ in shape]
        seg[tuple(slice(a, a + e) for a, e in zip(lo, ext))] = rng.randint(1, classes + 1)
    return seg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_helpers(seed):
    seg = random_seg(seed)
    for rm in ([2], [1, 3], []):
        assert_same(tprepare.remove_classes(seg, rm), jprepare.remove_classes(seg, rm))
    mapping = {1: 3, 3: 1, 4: 2}
    assert_same(tprepare.reorder_classes(seg, mapping), jprepare.reorder_classes(seg, mapping))
    for min_voxels in (0, 5):
        assert_same(tprepare.seg_to_instances(seg, min_voxels),
                    jprepare.seg_to_instances(seg, min_voxels))


@pytest.mark.parametrize("kwargs", [
    dict(), dict(fg_vs_bg=True), dict(rm_classes=[2], min_voxels=3),
    dict(ro_classes={1: 2, 2: 1}, subtract_one_of_classes=False, file_name="renamed")])
def test_instances_from_segmentation(tmp_path, kwargs):
    src = tmp_path / "case_7.nii.gz"
    jnifti.save(src, random_seg(3).astype(np.float32), np.asarray([2.5, 0.7, 0.8]))
    got = tprepare.instances_from_segmentation(src, tmp_path / "t", **kwargs)
    want = jprepare.instances_from_segmentation(src, tmp_path / "j", **kwargs)
    assert got == want
    assert_same_outputs(tmp_path / "t", tmp_path / "j")


@pytest.mark.parametrize("test_size, shuffle, modalities", [
    (0.3, True, 1), (0.5, False, 2), (0.0, True, 1)])
def test_create_test_split(tmp_path, test_size, shuffle, modalities):
    """The same case ids drawn with the same seed, and the same files moved."""
    for side in ("t", "j"):
        images, labels = tmp_path / side / "imagesTr", tmp_path / side / "labelsTr"
        images.mkdir(parents=True)
        labels.mkdir(parents=True)
        for i in range(11):
            for m in range(modalities):
                (images / f"case_{i}_{m:04d}.nii.gz").write_bytes(b"img")
            (labels / f"case_{i}.nii.gz").write_bytes(b"seg")
            if i % 3:
                (labels / f"case_{i}.json").write_text('{"instances": {}}')
    kw = dict(num_modalities=modalities, test_size=test_size, random_state=4, shuffle=shuffle)
    got = tprepare.create_test_split(tmp_path / "t", **kw)
    want = jprepare.create_test_split(tmp_path / "j", **kw)
    assert got == want and len(got) == round(11 * test_size)
    assert_same_outputs(tmp_path / "t", tmp_path / "j", parse=False)


# ----------------------------------------------------------------- save_get_crop
@pytest.mark.parametrize("mode", ["shift", "pad"])
@pytest.mark.parametrize("spatial_offset, dim", [(1, 3), (0, 3), (1, 2)])
def test_save_get_crop(mode, spatial_offset, dim):
    rng = np.random.RandomState(dim + 10 * spatial_offset)
    shape = (2,) * spatial_offset + tuple(rng.randint(5, 12, dim))
    data = rng.rand(*shape).astype(np.float32)
    spatial = np.asarray(shape[spatial_offset:])
    # drawn crops, then one wholly below and one wholly above the volume
    cases = [(rng.randint(2, 14, dim), rng.randint(-6, 12, dim)) for _ in range(25)]
    cases += [(np.full(dim, 3), np.full(dim, -5)), (np.full(dim, 3), spatial + 2)]
    for patch, origin in cases:
        got = tpatching.save_get_crop(data, origin, patch, spatial_offset, mode)
        crop, eff = got
        if mode == "pad" and not ((origin + patch > 0) & (origin < spatial)).all():
            # wholly outside the volume: the JAX package slices with a
            # negative end and returns another shape; the port pads the
            # patch with zeros (repaired in the port only)
            assert crop.shape == data.shape[:spatial_offset] + tuple(patch)
            assert not crop.any() and (eff == origin).all()
            continue
        assert_same(got, jpatching.save_get_crop(data, origin, patch, spatial_offset, mode))
        if mode == "pad":
            assert crop.shape[spatial_offset:] == tuple(patch)
        else:
            assert crop.shape[spatial_offset:] == tuple(np.minimum(patch, spatial))
            assert (eff >= 0).all()
