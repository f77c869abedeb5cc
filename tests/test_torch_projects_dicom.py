"""The port's DICOM converters against the JAX package's scripts on the
same synthetic raw layouts (``tests/test_dicom_converters.py``'s): the TCIA
lymph nodes (a DICOM series per patient, nested, and NIfTI masks) and
ProstateX (T2, ADC and PD-W series, the K-trans MetaImage, finding masks
and the findings table, resampled onto the T2 grid). Both sides run by
subprocess (``tests/test_torch_projects.py::run_both``); outputs compared
as arrays and parsed objects."""
import numpy as np
import pytest

from nndetection_tpu.data import nifti
from tests.test_dicom_converters import write_mhd, write_series
from tests.test_torch_converters import assert_same_outputs
from tests.test_torch_projects import run_both


@pytest.mark.parametrize("as_module", [True, False])
def test_lymph_nodes(tmp_path, as_module):
    rng = np.random.default_rng(3)
    images_root, masks_root = tmp_path / "CT Lymph Nodes", tmp_path / "MASKS"
    (masks_root / "nested").mkdir(parents=True)
    for i, patient in enumerate(("ABD_LYMPH_001", "ABD_LYMPH_002", "ABD_LYMPH_003")):
        vol = rng.integers(-500, 500, size=(6, 8, 8)).astype(np.int16)
        write_series(images_root / patient / "study" / "series1", vol,
                     spacing=(2.5, 0.8, 0.7), origin=(1.0, -2.0, 3.0 + i))
        mask = np.zeros(vol.shape, dtype=np.int32)
        mask[1:3, 1:4, 1:4] = 1
        mask[4:6, 5:8, 5:8] = 1
        mask[0, 7, 0] = 1  # under --min-voxels
        if patient == "ABD_LYMPH_002":  # a mask of another shape: skipped
            mask = mask[:, :7]
        if patient != "ABD_LYMPH_003":  # no mask: skipped
            nifti.save(masks_root / "nested" / f"{patient}_mask.nii.gz", mask, np.ones(3))
    got, want, stdout = run_both(tmp_path, "Task025_LymphNodes/prepare.py",
                                 ["--images", images_root, "--masks", masks_root,
                                  "--min-voxels", "3"], as_module)
    names = assert_same_outputs(got, want)
    assert "raw_splitted/labelsTr/ABD_LYMPH_001.json" in names
    assert "skip ABD_LYMPH_003: no mask" in stdout and "skip ABD_LYMPH_002: mask shape" in stdout


def test_prostatex(tmp_path):
    """Two cases: one whose modalities share the T2 grid, one whose ADC and
    K-trans lie on other grids (resampled in world coordinates), two
    findings of which one is not in the table; a third case without
    masks is skipped."""
    shape = (4, 8, 8)
    rng = np.random.default_rng(5)
    data_root, ktrans_root, masks_root = tmp_path / "PROSTATEx", tmp_path / "ktrans", \
        tmp_path / "masks"
    masks_root.mkdir()
    rows = []
    for n, cid in enumerate(("ProstateX-0000", "ProstateX-0001", "ProstateX-0002")):
        case = data_root / cid / "study"
        other = n == 1
        write_series(case / "3-t2tsetra", rng.integers(0, 800, size=shape), spacing=(3.0, 0.5, 0.5),
                     series_uid="1.1")
        write_series(case / "7-ep2dADC", rng.integers(0, 2000, size=(3, 6, 6) if other else shape),
                     spacing=(3.5, 0.7, 0.7) if other else (3.0, 0.5, 0.5),
                     origin=(0.3, 0.2, 0.5) if other else (0.0, 0.0, 0.0), series_uid="1.2")
        write_series(case / "5-tfl PD ref", rng.integers(0, 400, size=shape),
                     spacing=(3.0, 0.5, 0.5), series_uid="1.3")
        (ktrans_root / cid).mkdir(parents=True)
        write_mhd(ktrans_root / cid / f"{cid}-Ktrans.mhd",
                  rng.normal(size=(5, 7, 7) if other else shape).astype(np.float32),
                  spacing_xyz=(0.6, 0.6, 2.5) if other else (0.5, 0.5, 3.0))
        if n == 2:
            continue
        for fid in (1, 2) if other else (1,):
            m = np.zeros(shape, dtype=np.uint8)
            m[1:3, 2 * fid:2 * fid + 3, 2:5] = 1
            nifti.save(masks_root / f"{cid}-Finding{fid}-t2.nii.gz", m, np.ones(3))
        rows.append(f"{cid},1,0 0 0,{'TRUE' if n == 0 else 'FALSE'}")
    findings_csv = tmp_path / "findings.csv"
    findings_csv.write_text("ProxID,fid,pos,ClinSig\n" + "\n".join(rows) + "\n")
    got, want, stdout = run_both(
        tmp_path, "Task021_ProstateX/prepare.py",
        ["--data", data_root, "--ktrans", ktrans_root, "--t2-masks", masks_root,
         "--findings", findings_csv], as_module=True)
    names = assert_same_outputs(got, want)
    assert "raw_splitted/imagesTr/ProstateX-0001_0003.nii.gz" in names
    assert "skip ProstateX-0002: no masks" in stdout
    assert "finding 2 not in table" in stdout
