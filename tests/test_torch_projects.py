"""The port's dataset converters (``nndetection_tpu_torch/projects``) against
the JAX package's scripts (``projects/``) on the same synthetic raw layouts,
each side run by subprocess with the JAX script's arguments (as
``tests/test_project_converters.py::_run`` runs them): the Decathlon
converter, KiTS, LIDC (NRRD), LUNA16 (MetaImage), CADA, ADAM and RibFrac
here; ProstateX and the lymph nodes (DICOM) in
``tests/test_torch_projects_dicom.py``. The port's scripts run as files
(which insert the repository root, as the JAX scripts do) and as ``python
-m``, alternately. Images and labels are compared as arrays, JSON, YAML and
pickles as parsed objects (``assert_same_outputs``)."""
import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nndetection_tpu.data import nifti
from nndetection_tpu.data.luna_proxy import generate_luna_proxy
from tests.test_nrrd_lidc import write_nrrd
from tests.test_torch_converters import assert_same_outputs

REPO = Path(__file__).resolve().parents[1]


def run_both(tmp_path, script, args, as_module, out_name="task"):
    """``projects/<script>`` and the port's copy of it on the same
    arguments, run at the same time, each writing to its own ``--out``;
    returns both output directories and the port's standard output.
    ``args`` are the arguments before ``--out``."""
    port = (["-m", "nndetection_tpu_torch.projects." + script[: -len(".py")].replace("/", ".")]
            if as_module else [str(REPO / "nndetection_tpu_torch" / "projects" / script)])
    cmds = {"j": [str(REPO / "projects" / script)], "t": port}
    procs = {side: subprocess.Popen(
        [sys.executable, *cmd, *map(str, args), "--out", str(tmp_path / side / out_name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for side, cmd in cmds.items()}
    stdout = {side: proc.communicate(timeout=300)[0] for side, proc in procs.items()}
    for side, proc in procs.items():
        assert proc.returncode == 0, stdout[side]
    return tmp_path / "t" / out_name, tmp_path / "j" / out_name, stdout["t"]


def write_msd(src: Path):
    """A Medical Segmentation Decathlon task: two training cases (one 4D
    with two modalities), a test image and ``dataset.json`` with two
    semantic labels."""
    rng = np.random.RandomState(0)
    for d in ("imagesTr", "labelsTr", "imagesTs"):
        (src / d).mkdir(parents=True)
    (src / "dataset.json").write_text(json.dumps({
        "name": "Liver", "modality": {"0": "CT", "1": "MR"},
        "labels": {"0": "background", "1": "liver", "2": "tumour"}}))
    for cid, four_d in (("liver_0", False), ("liver_1", True)):
        img = rng.rand(*((2,) if four_d else ()), 10, 12, 12).astype(np.float32)
        seg = np.zeros((10, 12, 12), np.int16)
        seg[1:6, 1:8, 1:8] = 1
        seg[2:4, 2:4, 2:4] = 2
        seg[7:9, 9:11, 9:11] = 2
        seg[9, 0, 0] = 2
        nifti.save(src / "imagesTr" / f"{cid}.nii.gz", img, np.asarray([2.0, 0.8, 0.8]))
        nifti.save(src / "labelsTr" / f"{cid}.nii.gz", seg, np.asarray([2.0, 0.8, 0.8]))
    nifti.save(src / "imagesTs" / "liver_9.nii.gz", rng.rand(10, 12, 12).astype(np.float32))


@pytest.mark.parametrize("extra, as_module", [((), True),
                                              (("--target-labels", "2", "--min-size", "2"), False)])
def test_decathlon(tmp_path, extra, as_module):
    write_msd(tmp_path / "Task03_Liver")
    got, want, _ = run_both(tmp_path, "decathlon_converter.py",
                            ["--source", tmp_path / "Task03_Liver", *extra], as_module,
                            out_name="Task003_Liver")
    names = assert_same_outputs(got, want)
    assert "raw_splitted/imagesTr/liver_1_0001.nii.gz" in names
    assert "raw_splitted/imagesTs/liver_9_0000.nii.gz" in names


def test_kits(tmp_path):
    src = tmp_path / "kits"
    for idx in (0, 1, 2, 3, 4, 250):  # 250: the unlabeled test cohort
        case = src / f"case_{idx:05d}"
        case.mkdir(parents=True)
        img = np.random.default_rng(idx).normal(size=(12, 12, 12)).astype(np.float32)
        seg = np.zeros((12, 12, 12), dtype=np.int32)
        seg[2:6, 2:6, 2:6] = 1  # kidney: dropped
        seg[8:11, 8:11, 8:11] = 2  # tumour
        seg[0:2, 9:11, 0:2] = 2 if idx % 2 else 0
        nifti.save(case / "imaging.nii.gz", img, np.ones(3))
        nifti.save(case / "segmentation.nii.gz", seg, np.ones(3))
    got, want, stdout = run_both(tmp_path, "Task011_Kits/prepare.py",
                                 ["--source", src, "--test-size", "0.4", "--min-voxels", "3"],
                                 as_module=False)
    names = assert_same_outputs(got, want)
    assert sum(n.startswith("raw_splitted/imagesTs/") for n in names) == 2
    assert "converted 5 cases (2 moved to test split)" in stdout


def test_lidc(tmp_path):
    src = tmp_path / "lidc"
    shape = (10, 12, 12)
    for case_idx in (1, 2):
        cid = f"LIDC-IDRI-000{case_idx}"
        case = src / cid
        case.mkdir(parents=True)
        img = np.random.default_rng(case_idx).integers(-500, 500, size=shape).astype(np.int16)
        write_nrrd(case / f"{cid}_ct_scan.nrrd", img, [0.7, 0.7, 2.5])
        m = np.zeros(shape, dtype=np.uint8)
        m[2:5, 2:5, 2:5] = 1
        for rid in (1, 2, 3)[:case_idx + 1]:
            nifti.save(case / f"{cid}_mask_001_{rid}.nii.gz", m, np.ones(3))
        m2 = np.zeros(shape, dtype=np.uint8)
        m2[7:9, 7:9, 7:9] = 1
        for rid in (1, 2):
            nifti.save(case / f"{cid}_mask_002_{rid}.nii.gz", m2, np.ones(3))
    with open(src / "characteristics.csv", "w") as f:
        f.write("PatientID,NoduleID,Malignancy\n")
        f.write("LIDC-IDRI-0001,1,4\nLIDC-IDRI-0001,1,2\nLIDC-IDRI-0001,2,-1\n")
        f.write("LIDC-IDRI-0002,1,5\nLIDC-IDRI-0002,2,3\nLIDC-IDRI-0002,2,2\n")
    got, want, _ = run_both(tmp_path, "Task012_LIDC/prepare.py", ["--source", src],
                            as_module=True)
    assert_same_outputs(got, want)
    mapping = json.loads((got / "raw_splitted" / "labelsTr" / "LIDC-IDRI-0002.json").read_text())
    assert mapping == {"instances": {"1": 1, "2": 0}, "scores": {"1": 5.0, "2": 2.5}}


def test_luna(tmp_path):
    """The LUNA16 layout (the proxy generator's ``subset*/*.mhd`` + ``.zraw``
    and ``annotations.csv``): images, spherical instance masks, geometry
    pickles, ``luna_subsets.json`` and ``dataset.yaml``."""
    src = generate_luna_proxy(tmp_path / "LUNA16", num_cases=3, seed=1, inplane=48,
                              num_subsets=2)
    with open(src / "annotations.csv") as f:
        assert len(list(csv.DictReader(f))) >= 1
    got, want, _ = run_both(tmp_path, "Task016_Luna/prepare.py", ["--source", src],
                            as_module=False, out_name="Task016_Luna")
    names = assert_same_outputs(got, want)
    assert "luna_subsets.json" in names and "raw_splitted/labelsTr/proxy_0000_geometry.pkl" in names


def test_cada(tmp_path):
    src = tmp_path / "cada"
    (src / "train_dataset").mkdir(parents=True)
    (src / "train_mask_images").mkdir(parents=True)
    for cid, n_inst in (("A001", 2), ("A002", 3), ("A003", 0)):
        mask = np.zeros((10, 10, 10), dtype=np.int32)
        for i in range(1, n_inst + 1):
            mask[3 * i - 2:3 * i, 1:3, 1:3] = i
        nifti.save(src / "train_dataset" / f"{cid}_orig.nii.gz",
                   np.full((10, 10, 10), float(n_inst), np.float32), np.ones(3))
        if cid != "A003":  # no mask: skipped
            nifti.save(src / "train_mask_images" / f"{cid}_labeledMasks.nii.gz", mask, np.ones(3))
    got, want, stdout = run_both(tmp_path, "Task017_CADA/prepare.py", ["--source", src],
                                 as_module=True)
    assert_same_outputs(got, want)
    assert "skip A003: no mask" in stdout


def test_adam(tmp_path):
    src = tmp_path / "adam"
    rng = np.random.RandomState(3)
    for subj in ("10001", "10002", "10003"):
        (src / subj / "pre").mkdir(parents=True)
        mask = np.zeros((10, 10, 10), dtype=np.int32)
        mask[2:4, 2:4, 2:4] = 1
        mask[7:9, 7:9, 7:9] = 2
        mask[4, 7:9, 2:4] = 2
        nifti.save(src / subj / "pre" / "struct_aligned.nii.gz",
                   rng.rand(10, 10, 10).astype(np.float32), np.ones(3))
        if subj != "10003":  # missing TOF: skipped
            nifti.save(src / subj / "pre" / "TOF.nii.gz",
                       rng.rand(10, 10, 10).astype(np.float32), np.ones(3))
        nifti.save(src / subj / "aneurysms.nii.gz", mask, np.ones(3))
    got, want, _ = run_both(tmp_path, "Task019_ADAM/prepare.py", ["--source", src],
                            as_module=False, out_name="Task019FG_ADAM")
    names = assert_same_outputs(got, want)
    assert "raw_splitted/imagesTr/10002_0001.nii.gz" in names
    assert not any("10003" in n for n in names)


def test_ribfrac(tmp_path):
    """Instances with label codes -1 and 0 dropped, the others renumbered;
    a label found elsewhere in the tree; a case without a code row."""
    src = tmp_path / "ribfrac"
    (src / "images").mkdir(parents=True)
    (src / "labels").mkdir(parents=True)
    rng = np.random.RandomState(4)
    for cid in ("RibFrac1", "RibFrac2", "RibFrac3"):
        seg = np.zeros((10, 10, 10), np.int16)
        for i in range(1, 5):
            seg[2 * i:2 * i + 1, 1:4, 1:4] = i
        img_dir = src / "images"
        lab_dir = img_dir if cid == "RibFrac1" else src / "labels"
        nifti.save(img_dir / f"{cid}-image.nii.gz", rng.rand(10, 10, 10).astype(np.float32),
                   np.asarray([1.25, 0.7, 0.7]))
        nifti.save(lab_dir / f"{cid}-label.nii.gz", seg, np.asarray([1.25, 0.7, 0.7]))
    (src / "ribfrac-train-info.csv").write_text(
        "public_id,label_id,label_code\n"
        "RibFrac1,0,0\nRibFrac1,1,1\nRibFrac1,2,-1\nRibFrac1,3,3\nRibFrac1,4,0\n"
        "RibFrac2,1,2\nRibFrac2,2,4\n")
    got, want, _ = run_both(tmp_path, "Task020_RibFrac/prepare.py", ["--source", src],
                            as_module=True, out_name="Task020_RibFrac")
    assert_same_outputs(got, want)
    mapping = json.loads((got / "raw_splitted" / "labelsTr" / "RibFrac1.json").read_text())
    assert mapping == {"instances": {"1": 0, "2": 0}}
