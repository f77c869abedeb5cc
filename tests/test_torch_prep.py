"""The port's host prep against the JAX package's: NIfTI IO both ways,
``discover_cases``, ``crop_to_nonzero``, the three normalization schemes,
``resample_patient`` (isotropic, anisotropic, separate z from either
spacing), the instance helpers, and crop -> analyze -> process -> unpack on
``data/example.py``'s toy task with anisotropic, unequal spacings. Arrays
are held bit for bit, pickled properties key by key with exact equality."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nndetection_tpu.data import crop as jcrop
from nndetection_tpu.data import dataset as jdataset
from nndetection_tpu.data import example as jexample
from nndetection_tpu.data import instances as jinstances
from nndetection_tpu.data import nifti as jnifti
from nndetection_tpu.data import normalize as jnormalize
from nndetection_tpu.data import preprocess as jpreprocess
from nndetection_tpu.data import resample as jresample
from nndetection_tpu_torch.data import crop as tcrop
from nndetection_tpu_torch.data import dataset as tdataset
from nndetection_tpu_torch.data import example as texample
from nndetection_tpu_torch.data import instances as tinstances
from nndetection_tpu_torch.data import nifti as tnifti
from nndetection_tpu_torch.data import normalize as tnormalize
from nndetection_tpu_torch.data import preprocess as tpreprocess
from nndetection_tpu_torch.data import resample as tresample
from nndetection_tpu_torch.utils.io import load_pickle

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# (z, y, x) spacings of the toy task's cases: anisotropic beyond the
# separate-z threshold, and unequal, so every case is resampled
TOY_SPACINGS = [(4.0, 1.0, 1.0), (3.5, 0.9, 0.9), (4.5, 1.1, 1.0), (4.0, 0.8, 0.8)]


def assert_same(got, want, where="value"):
    """Exact equality of nested dicts, lists, tuples, arrays, scalars and
    dataclasses: the same types, keys, dtypes, shapes and every bit (NaN
    equal to NaN); a dataclass of either package (a ``Plan``) by its class
    name and fields."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, (where, type(got), type(want))
        assert_same(dataclasses.asdict(got), dataclasses.asdict(want), where)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (where, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
        assert np.array_equal(got, want, equal_nan=got.dtype.kind in "fc"), where
    else:
        assert type(got) is type(want), (where, type(got), type(want))
        assert got == want or (got != got and want != want), (where, got, want)


# ----------------------------------------------------------------- NIfTI
@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8", "float64"])
@pytest.mark.parametrize("suffix", [".nii.gz", ".nii"])
def test_nifti_both_ways(tmp_path, dtype, suffix):
    rng = np.random.RandomState(0)
    data = (rng.rand(5, 7, 9) * 100).astype(dtype)
    spacing = np.asarray([2.5, 0.7, 0.8])
    affine = np.diag([0.8, 0.7, 2.5, 1.0])
    affine[:3, 3] = [-10.0, 3.5, 7.0]
    for save, load in ((jnifti.save, tnifti.load), (tnifti.save, jnifti.load)):
        path = tmp_path / f"{save.__module__.split('.')[0]}{suffix}"
        save(path, data, spacing=spacing, affine=affine)
        got, want = load(path), jnifti.load(path)
        for g, w in zip(got, want):
            assert_same(g, w)
        assert_same(got[0], data)
        np.testing.assert_array_equal(got[1], spacing.astype(np.float32))
    if suffix == ".nii":  # uncompressed: the same bytes
        assert (tmp_path / f"nndetection_tpu{suffix}").read_bytes() == \
            (tmp_path / f"nndetection_tpu_torch{suffix}").read_bytes()


def test_nifti_2d_default_affine(tmp_path):
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    tnifti.save(tmp_path / "t.nii.gz", data, spacing=[0.5, 2.0])
    jnifti.save(tmp_path / "j.nii.gz", data, spacing=[0.5, 2.0])
    for name in ("t", "j"):
        for g, w in zip(tnifti.load(tmp_path / f"{name}.nii.gz"),
                        jnifti.load(tmp_path / f"{name}.nii.gz")):
            assert_same(g, w)


# ---------------------------------------------------------- the raw task
def write_toy_task(root: Path, generate, nifti, num_train=4, image_size=(12, 24, 24)):
    """``data/example.py``'s toy task, each case re-saved at its spacing of
    ``TOY_SPACINGS``, and the image made CT-like (HU, zero background)."""
    task = generate(root / "Task000D3_Example", num_train=num_train, num_test=1,
                    image_size=image_size, object_size=(5, 9), object_width=1)
    for i in range(num_train):
        sp = np.asarray(TOY_SPACINGS[i % len(TOY_SPACINGS)])
        img = task / "raw_splitted" / "imagesTr" / f"case_{i}_0000.nii.gz"
        lab = task / "raw_splitted" / "labelsTr" / f"case_{i}.nii.gz"
        data, _, _ = nifti.load(img)
        data = data * 1400.0 - 1000.0
        data[:, :2] = 0.0  # air outside the body: the crop removes it
        nifti.save(img, data.astype(np.float32), spacing=sp)
        nifti.save(lab, nifti.load(lab)[0], spacing=sp)
    return task


def test_example_writes_the_same_task(tmp_path):
    t = texample.generate_example_dataset(tmp_path / "t" / "Task000D3_Example", num_train=2,
                                          num_test=1, image_size=(8, 12, 10), object_size=(4, 7),
                                          spacing=(2, 1, 1))
    j = jexample.generate_example_dataset(tmp_path / "j" / "Task000D3_Example", num_train=2,
                                          num_test=1, image_size=(8, 12, 10), object_size=(4, 7),
                                          spacing=(2, 1, 1))
    files = sorted(p.relative_to(j) for p in j.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(t) for p in t.rglob("*") if p.is_file())
    for f in files:
        if f.suffix == ".gz":
            for g, w in zip(tnifti.load(t / f), jnifti.load(j / f)):
                assert_same(g, w)
        else:
            assert (t / f).read_text() == (j / f).read_text()
    rng_t, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    for g, w in zip(texample.generate_case(rng_t, (12, 20, 20)),
                    jexample.generate_case(rng_j, (12, 20, 20))):
        assert_same(g, w)


def test_discover_cases(tmp_path):
    task = write_toy_task(tmp_path, jexample.generate_example_dataset, jnifti)
    sp = task / "raw_splitted"
    for args in ((sp / "imagesTr", sp / "labelsTr", 1), (sp / "imagesTs",)):
        got = tdataset.discover_cases(*args)
        want = jdataset.discover_cases(*args)
        assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]
        assert [c.instances() for c in got] == [c.instances() for c in want]
    with pytest.raises(ValueError, match="modalities"):
        tdataset.discover_cases(sp / "imagesTr", num_modalities=2)


# ------------------------------------------------------ crop, normalize
def test_crop_to_nonzero():
    rng = np.random.RandomState(1)
    data = np.zeros((2, 10, 12, 14), np.float32)
    data[0, 2:8, 3:10, 1:12] = rng.rand(6, 7, 11) + 0.1
    data[1, 3:9, 2:9, 4:13] = rng.rand(6, 7, 9) + 0.1
    data[0, 4, 5, 6] = 0.0  # a hole, filled by the mask
    seg = np.zeros((10, 12, 14), np.int16)
    seg[4:6, 4:7, 5:9] = 1
    seg[6:8, 3:5, 9:11] = 2
    for s in (seg, None):
        for g, w in zip(tcrop.crop_to_nonzero(data, s), jcrop.crop_to_nonzero(data, s)):
            assert_same(g, w)
    assert_same(tcrop.nonzero_bbox(np.zeros((3, 4), bool)),
                jcrop.nonzero_bbox(np.zeros((3, 4), bool)))


def test_normalize_case_three_schemes():
    rng = np.random.RandomState(2)
    data = (rng.randn(3, 6, 8, 8) * 300 + 40).astype(np.float32)
    mask = rng.rand(6, 8, 8) > 0.3
    stats = {c: {"percentile_00_5": -500.0 + 10 * c, "percentile_99_5": 600.0, "mean": 30.0,
                 "sd": 200.0} for c in range(3)}
    for schemes in (["CT", "CT2", "nonCT"], ["nonCT"] * 3):
        for use_mask in (False, True):
            got = tnormalize.normalize_case(data, schemes, stats, mask, use_mask)
            want = jnormalize.normalize_case(data, schemes, stats, mask, use_mask)
            assert_same(got, want)


# -------------------------------------------------------------- resample
@pytest.mark.parametrize("original, target", [
    ((1.0, 1.0, 1.0), (1.3, 0.8, 1.1)),  # isotropic, no separate z
    ((4.0, 1.0, 1.0), (3.0, 0.9, 0.9)),  # separate z from the original spacing
    ((2.0, 1.0, 1.0), (4.0, 1.0, 1.0)),  # separate z from the target spacing
    ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0)),  # the same shape: a copy
])
def test_resample_patient(original, target):
    rng = np.random.RandomState(3)
    data = rng.randn(2, 7, 15, 13).astype(np.float32)
    seg = np.zeros((7, 15, 13), np.int16)
    seg[2:5, 3:9, 4:10] = 1
    seg[4:7, 10:14, 1:5] = 2
    seg[0] = -1
    for g, w in zip(tresample.resample_patient(data, seg, original, target),
                    jresample.resample_patient(data, seg, original, target)):
        assert_same(g, w)
    assert_same(tresample.resample_patient(data, None, original, target)[0],
                jresample.resample_patient(data, None, original, target)[0])
    assert tresample.get_do_separate_z(original) == jresample.get_do_separate_z(original)
    assert_same(tresample.compute_new_shape(data.shape[1:], original, target),
                jresample.compute_new_shape(data.shape[1:], original, target))


@pytest.mark.parametrize("ndim", [2, 3])
def test_instances_np(ndim):
    rng = np.random.RandomState(4)
    seg = rng.randint(-1, 4, size=(9, 11, 7)[:ndim]).astype(np.int16)
    seg[seg == 2] = 0  # an id with no voxel
    for ids in (None, [3, 1, 2]):
        for g, w in zip(tinstances.instances_to_boxes_np(seg, ids),
                        jinstances.instances_to_boxes_np(seg, ids)):
            assert_same(g, w)
    table = {1: 0, 3: 1, 2: 1}
    assert_same(tinstances.instances_to_segmentation_np(seg, table),
                jinstances.instances_to_segmentation_np(seg, table))
    assert_same(tinstances.instances_to_boxes_np(np.zeros((4,) * ndim, np.int16)),
                jinstances.instances_to_boxes_np(np.zeros((4,) * ndim, np.int16)))


# ------------------------------------------- crop -> analyze -> process
def stage_outputs(task: Path, mod, target, transpose, schemes, use_mask):
    """``mod``'s crop, analyze, process and unpack of ``task`` into
    ``task/raw_cropped`` and ``task/out``; returns the dataset properties."""
    ds = tdataset if mod is tpreprocess else jdataset
    cases = ds.discover_cases(task / "raw_splitted" / "imagesTr",
                              task / "raw_splitted" / "labelsTr", 1)
    mod.run_cropping(cases, task / "raw_cropped")
    ids = [c.case_id for c in cases]
    props = mod.analyze_dataset(task / "raw_cropped", ids, 1)
    for cid in ids:
        mod.process_case(task / "raw_cropped", task / "out" / "imagesTr", task / "out" / "labelsTr",
                         cid, target_spacing=np.asarray(target), transpose_forward=transpose,
                         normalization_schemes=schemes,
                         intensity_properties=props["intensity_properties"],
                         use_nonzero_mask=use_mask)
    mod.unpack_dataset(task / "out" / "imagesTr")
    return props


def assert_same_tree(got_dir: Path, want_dir: Path):
    """Every file of ``want_dir`` in ``got_dir`` with the same arrays
    (``.npz``, ``.npy``) or pickled objects (``.pkl``), and no other file."""
    files = sorted(p.relative_to(want_dir) for p in want_dir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(got_dir) for p in got_dir.rglob("*") if p.is_file())
    for f in files:
        if f.suffix == ".npz":
            with np.load(got_dir / f) as g, np.load(want_dir / f) as w:
                assert_same({k: g[k] for k in g.files}, {k: w[k] for k in w.files}, str(f))
        elif f.suffix == ".npy":
            assert_same(np.load(got_dir / f), np.load(want_dir / f), str(f))
        else:
            assert_same(load_pickle(got_dir / f), load_pickle(want_dir / f), str(f))
    return files


@pytest.mark.parametrize("schemes, use_mask", [(["CT"], False), (["nonCT"], True)])
def test_prep_stages_match_jax(tmp_path, schemes, use_mask):
    """The toy task through both packages' stages: the cropped cases, the
    dataset properties, the processed cases with their candidates and GT,
    and the unpacked arrays, at a target spacing that resamples every case
    and a transpose that moves the coarse axis."""
    target, transpose = (3.0, 0.95, 1.05), [0, 2, 1]
    got_task = write_toy_task(tmp_path / "t", texample.generate_example_dataset, tnifti)
    want_task = write_toy_task(tmp_path / "j", jexample.generate_example_dataset, jnifti)
    got = stage_outputs(got_task, tpreprocess, target, transpose, schemes, use_mask)
    want = stage_outputs(want_task, jpreprocess, target, transpose, schemes, use_mask)
    assert_same(got, want, "dataset_properties")
    assert_same_tree(got_task / "raw_cropped", want_task / "raw_cropped")
    files = assert_same_tree(got_task / "out", want_task / "out")
    assert {f.suffix for f in files} == {".npz", ".npy", ".pkl"}
    assert len(got["boxes_mm"]) >= 4 and got["class_ids"]


def test_pooled_stages_match_one_process(tmp_path):
    """``run_cropping`` and ``analyze_dataset`` in two worker processes (a
    fresh interpreter that imports the port only) give what one process
    gives."""
    task = write_toy_task(tmp_path, texample.generate_example_dataset, tnifti)
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from nndetection_tpu_torch.data import dataset as d, preprocess as p\n"
        "from nndetection_tpu_torch.utils.io import save_pickle\n"
        "task = Path(sys.argv[1])\n"
        "cases = d.discover_cases(task / 'raw_splitted' / 'imagesTr',\n"
        "                         task / 'raw_splitted' / 'labelsTr', 1)\n"
        "p.run_cropping(cases, task / 'pooled', num_workers=2)\n"
        "props = p.analyze_dataset(task / 'pooled', [c.case_id for c in cases], 1,\n"
        "                          num_workers=2)\n"
        "save_pickle(props, task / 'pooled_props.pkl')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(task)], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    cases = tdataset.discover_cases(task / "raw_splitted" / "imagesTr",
                                    task / "raw_splitted" / "labelsTr", 1)
    tpreprocess.run_cropping(cases, task / "single")
    props = tpreprocess.analyze_dataset(task / "single", [c.case_id for c in cases], 1)
    assert_same(load_pickle(task / "pooled_props.pkl"), props)
    assert_same_tree(task / "pooled", task / "single")
