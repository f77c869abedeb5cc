"""ProstateX (multi-parametric prostate MRI) -> standard detection format.

The port's copy of the repository's
``projects/Task021_ProstateX/prepare.py``: the same names, signatures and
outputs, with its imports pointed at the port.

Semantic equivalent of nnDetection's ``projects/Task021_ProstateX``: per
case, four aligned modalities — T2 (the reference grid), ADC, a PD-W series
and the K-trans ``.mhd`` map — plus per-finding T2-space masks and the
findings table (``ProstateX-Findings-Train.csv``: ``ProxID, fid, ClinSig``).
ADC / PD-W / K-trans are resampled onto the T2 grid in world coordinates
(the reference's ``ResampleImageFilter.SetReferenceImage`` early-fusion
step); per-finding masks are merged into one instance map (instance id =
order of the finding's mask file); the instance class is the finding's
clinical significance (0/1).

Series selection uses name patterns (``*t2*``/``*ADC*``/``* PD *`` directory
globs) rather than the reference's per-case mask-table series ids — the
hand-maintained per-case exceptions of the reference script (cases 0025 /
0113) are intentionally not reproduced.

Usage:
    python -m nndetection_tpu_torch.projects.Task021_ProstateX.prepare \
        --data /data/PROSTATEx --ktrans /data/ktrans \
        --t2-masks /data/masks_t2 --findings ProstateX-Findings-Train.csv \
        [--out $det_data/Task021_ProstateX]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from nndetection_tpu_torch.data import dicom, mhd, nifti  # noqa: E402
from nndetection_tpu_torch.utils.io import save_json, save_yaml  # noqa: E402


def load_findings(csv_path) -> dict:
    """{case_id: {fid: clin_sig}}"""
    table: dict = defaultdict(dict)
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            sig = str(row.get("ClinSig", "")).strip().lower() in ("true", "1")
            table[row["ProxID"].strip()][int(row["fid"])] = int(sig)
    return table


def pick_series(case_root: Path, pattern: str) -> Path:
    """Latest-sorted series directory matching the glob pattern."""
    cands = sorted(d for d in case_root.rglob(pattern) if d.is_dir())
    if not cands:
        raise FileNotFoundError(f"no '{pattern}' series under {case_root}")
    return cands[-1]


def finding_id_of(mask_path: Path) -> int:
    for token in mask_path.name.split("-"):
        if token.lower().startswith("finding"):
            digits = "".join(c for c in token if c.isdigit())
            if digits:
                return int(digits)
    return 1


def prepare_case(case_id, data_root, ktrans_root, t2_masks, findings,
                 images, labels) -> bool:
    case_root = data_root / case_id
    t2_vol, t2_sp, t2_or, t2_dir = dicom.load_series(pick_series(case_root, "*t2*"))
    t2_aff = dicom.affine_from_geometry(t2_sp, t2_or, t2_dir)
    nifti.save(images / f"{case_id}_0000.nii.gz", t2_vol, t2_sp, t2_aff)

    for mod_idx, pattern in ((1, "*ADC*"), (2, "* PD *")):
        vol, sp, orig, dirm = dicom.load_series(pick_series(case_root, pattern))
        aff = dicom.affine_from_geometry(sp, orig, dirm)
        res = dicom.resample_to_reference(vol, aff, t2_vol.shape, t2_aff)
        nifti.save(images / f"{case_id}_{mod_idx:04d}.nii.gz", res, t2_sp, t2_aff)

    kt_path = ktrans_root / case_id / f"{case_id}-Ktrans.mhd"
    kt_vol, kt_sp, kt_or = mhd.load(kt_path)
    kt_aff = np.eye(4)
    kt_aff[:3, :3] = np.diag(kt_sp[::-1])
    kt_aff[:3, 3] = kt_or
    res = dicom.resample_to_reference(
        kt_vol.astype(np.float32), kt_aff, t2_vol.shape, t2_aff
    )
    nifti.save(images / f"{case_id}_0003.nii.gz", res, t2_sp, t2_aff)

    mask_paths = sorted(t2_masks.glob(f"{case_id}*"))
    if not mask_paths:
        return False
    instance_map = np.zeros(t2_vol.shape, dtype=np.int32)
    instances = {}
    case_findings = findings.get(case_id, {})
    for idx, mp in enumerate(mask_paths, start=1):
        m, _, _ = nifti.load(mp)
        instance_map[np.rint(m) > 0] = idx
        fid = finding_id_of(mp)
        if fid not in case_findings:
            print(f"{case_id}: finding {fid} not in table, class 0 assumed")
        instances[str(idx)] = int(case_findings.get(fid, 0))
    nifti.save(labels / f"{case_id}.nii.gz", instance_map, t2_sp, t2_aff)
    save_json({"instances": instances}, labels / f"{case_id}.json")
    return True


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="PROSTATEx DICOM root")
    p.add_argument("--ktrans", required=True, help="K-trans mhd root")
    p.add_argument("--t2-masks", required=True, help="T2-space finding masks dir")
    p.add_argument("--findings", required=True, help="ProstateX-Findings-Train.csv")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    data_root = Path(args.data)
    out = Path(args.out or Path(os.environ.get("det_data", ".")) / "Task021_ProstateX")
    images = out / "raw_splitted" / "imagesTr"
    labels = out / "raw_splitted" / "labelsTr"
    images.mkdir(parents=True, exist_ok=True)
    labels.mkdir(parents=True, exist_ok=True)

    save_yaml(
        {
            "task": "Task021_ProstateX",
            "name": "ProstateX",
            "dim": 3,
            "modalities": {0: "T2", 1: "ADC", 2: "PDW", 3: "KTrans"},
            "labels": {0: "benign", 1: "clinically_significant"},
            "target_class": 1,
            "test_labels": False,
        },
        out / "dataset.yaml",
    )

    findings = load_findings(args.findings)
    n = 0
    for case_dir in sorted(d for d in data_root.iterdir() if d.is_dir()):
        try:
            ok = prepare_case(
                case_dir.name, data_root, Path(args.ktrans), Path(args.t2_masks),
                findings, images, labels,
            )
        except (FileNotFoundError, ValueError) as exc:
            print(f"skip {case_dir.name}: {exc}")
            continue
        if ok:
            n += 1
        else:
            print(f"skip {case_dir.name}: no masks")
    print(f"converted {n} cases -> {out}")


if __name__ == "__main__":
    main()
