"""LIDC-IDRI (4-rater lung nodule annotations) -> standard detection format.

The port's copy of the repository's ``projects/Task012_LIDC/prepare.py``:
the same names, signatures and outputs, with its imports pointed at the
port.

Semantic equivalent of nnDetection's ``projects/Task012_LIDC`` (the
MIC-preprocessed layout): each case directory holds ``<case>_ct_scan.nrrd``
plus one binary NIfTI mask per (nodule, rater), named
``<case>_mask_<noduleid>_<roiid>.nii.gz``, and a ``characteristics.csv``
(columns ``PatientID, NoduleID, Malignancy``) with per-rater malignancy
ratings 1..5 (-1 = missing).

Per nodule the <=4 rater masks are averaged and thresholded at 0.5 (rater
majority vote; missing raters count as all-zero votes, exactly like the
reference's zero-padding to 4 raters); nodules that no majority kept are
dropped.  The instance class is the binarized mean malignancy
(``mean >= 3`` -> class 1 "malignant", else class 0 "benign"); the raw mean
score is kept under ``"scores"`` in the instances json for the
score-regression variants.

Usage:
    python -m nndetection_tpu_torch.projects.Task012_LIDC.prepare --source /data/lidc_mic \
        [--out $det_data/Task012_LIDC]
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

from nndetection_tpu_torch.data import nifti, nrrd  # noqa: E402
from nndetection_tpu_torch.utils.io import save_json, save_yaml  # noqa: E402


def load_malignancy(csv_path) -> dict:
    """{patient_id: {nodule_id: [ratings...]}}"""
    table: dict = defaultdict(lambda: defaultdict(list))
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            table[row["PatientID"]][str(int(row["NoduleID"]))].append(
                float(row["Malignancy"])
            )
    return table


def convert_case(case_dir: Path, ratings: dict, images: Path, labels: Path) -> int:
    cid = case_dir.name
    img, spacing, _ = nrrd.load(case_dir / f"{cid}_ct_scan.nrrd")
    affine = np.eye(4)
    affine[:3, :3] = np.diag(spacing[::-1])
    nifti.save(images / f"{cid}_0000.nii.gz", img.astype(np.float32), spacing, affine)

    by_nodule: dict = defaultdict(list)
    for mask_path in sorted(case_dir.glob("*.nii.gz")):
        tokens = mask_path.name[: -len(".nii.gz")].split("_")
        nodule_id, _roi_id = tokens[-2].lstrip("0") or "0", tokens[-1]
        by_nodule[nodule_id].append(mask_path)

    instance_map = np.zeros(img.shape, dtype=np.int32)
    instances, scores = {}, {}
    next_id = 1
    for nodule_id, paths in sorted(by_nodule.items()):
        votes = np.zeros(img.shape, dtype=np.float32)
        for p in paths:
            m, _, _ = nifti.load(p)
            votes += (np.rint(m) > 0).astype(np.float32)
        votes /= 4.0  # missing raters are implicit all-zero votes
        majority = votes >= 0.5
        if not majority.any():
            print(f"{cid}: nodule {nodule_id} suppressed by rater majority vote")
            continue
        rater_labels = [
            r for r in ratings.get(nodule_id, []) if r > -1
        ] or [0.0]
        mal = float(np.mean(rater_labels))
        instance_map[majority] = next_id
        instances[str(next_id)] = int(mal >= 3)
        scores[str(next_id)] = mal
        next_id += 1

    nifti.save(labels / f"{cid}.nii.gz", instance_map, spacing, affine)
    save_json({"instances": instances, "scores": scores}, labels / f"{cid}.json")
    return len(instances)


def main():
    p = argparse.ArgumentParser()
    p.add_argument(
        "--source",
        required=True,
        help="preprocessed LIDC root (<case>/<case>_ct_scan.nrrd + masks, "
        "characteristics.csv)",
    )
    p.add_argument("--out", default=None)
    args = p.parse_args()

    source = Path(args.source)
    out = Path(args.out or Path(os.environ.get("det_data", ".")) / "Task012_LIDC")
    images = out / "raw_splitted" / "imagesTr"
    labels = out / "raw_splitted" / "labelsTr"
    images.mkdir(parents=True, exist_ok=True)
    labels.mkdir(parents=True, exist_ok=True)

    save_yaml(
        {
            "task": "Task012_LIDC",
            "name": "LIDC",
            "dim": 3,
            "modalities": {0: "CT"},
            "labels": {0: "benign", 1: "malignant"},
            "target_class": None,
            "test_labels": True,
        },
        out / "dataset.yaml",
    )

    table = load_malignancy(source / "characteristics.csv")
    n_cases = n_nodules = 0
    for case_dir in sorted(p for p in source.iterdir() if p.is_dir()):
        if not (case_dir / f"{case_dir.name}_ct_scan.nrrd").exists():
            continue
        n_nodules += convert_case(case_dir, table.get(case_dir.name, {}), images, labels)
        n_cases += 1
    print(f"converted {n_cases} cases / {n_nodules} nodules -> {out}")


if __name__ == "__main__":
    main()
