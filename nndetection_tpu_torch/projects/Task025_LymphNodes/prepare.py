"""TCIA CT Lymph Nodes -> standard detection format.

The port's copy of the repository's
``projects/Task025_LymphNodes/prepare.py``: the same names, signatures and
outputs, with its imports pointed at the port.

Semantic equivalent of nnDetection's ``projects/Task025_LymphNodes``
(README-documented layout): ``raw/CT Lymph Nodes/<patient>/.../<series>/*.dcm``
CT series plus ``raw/MED_ABD_LYMPH_MASKS/<patient>/<patient>_mask.nii.gz``
(or flat ``<patient>*.nii.gz``) lymph-node masks.  Each patient's DICOM
series is assembled with :mod:`nndetection_tpu_torch.data.dicom`, the mask is
split into connected-component instances, and everything is run
foreground-vs-background with a single "lymph node" class.

Usage:
    python -m nndetection_tpu_torch.projects.Task025_LymphNodes.prepare \
        --images "/data/Task025/raw/CT Lymph Nodes" \
        --masks /data/Task025/raw/MED_ABD_LYMPH_MASKS \
        [--out $det_data/Task025_LymphNodes]
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from nndetection_tpu_torch.data import dicom, nifti  # noqa: E402
from nndetection_tpu_torch.data.prepare import seg_to_instances  # noqa: E402
from nndetection_tpu_torch.utils.io import save_json, save_yaml  # noqa: E402


def find_series_dir(patient_dir: Path) -> Path:
    """Deepest directory under the patient with the most DICOM files."""
    best, best_n = None, 0
    for d in [patient_dir, *patient_dir.rglob("*")]:
        if not d.is_dir():
            continue
        n = sum(1 for f in d.iterdir() if f.is_file() and f.suffix.lower() in ("", ".dcm"))
        if n > best_n:
            best, best_n = d, n
    if best is None:
        raise FileNotFoundError(f"no DICOM series under {patient_dir}")
    return best


def find_mask(masks_root: Path, patient: str):
    cands = sorted(masks_root.rglob(f"{patient}*mask*.nii.gz")) or sorted(
        masks_root.rglob(f"{patient}*.nii.gz")
    )
    return cands[0] if cands else None


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--images", required=True, help="'CT Lymph Nodes' DICOM root")
    p.add_argument("--masks", required=True, help="MED_ABD_LYMPH_MASKS root")
    p.add_argument("--out", default=None)
    p.add_argument("--min-voxels", type=int, default=3)
    args = p.parse_args()

    images_root = Path(args.images)
    masks_root = Path(args.masks)
    out = Path(args.out or Path(os.environ.get("det_data", ".")) / "Task025_LymphNodes")
    images = out / "raw_splitted" / "imagesTr"
    labels = out / "raw_splitted" / "labelsTr"
    images.mkdir(parents=True, exist_ok=True)
    labels.mkdir(parents=True, exist_ok=True)

    save_yaml(
        {
            "task": "Task025_LymphNodes",
            "name": "LymphNodes",
            "dim": 3,
            "modalities": {0: "CT"},
            "labels": {0: "lymph_node"},
            "target_class": None,
            "test_labels": False,
        },
        out / "dataset.yaml",
    )

    n = 0
    for patient_dir in sorted(d for d in images_root.iterdir() if d.is_dir()):
        patient = patient_dir.name
        mask_path = find_mask(masks_root, patient)
        if mask_path is None:
            print(f"skip {patient}: no mask")
            continue
        vol, spacing, origin, direction = dicom.load_series(
            find_series_dir(patient_dir)
        )
        affine = dicom.affine_from_geometry(spacing, origin, direction)
        nifti.save(images / f"{patient}_0000.nii.gz", vol, spacing, affine)

        mask, mspacing, maffine = nifti.load(mask_path)
        mask = (np.rint(mask) > 0).astype(np.int32)
        if mask.shape != vol.shape:
            print(
                f"skip {patient}: mask shape {mask.shape} != image {vol.shape}"
            )
            continue
        inst, classes = seg_to_instances(mask, min_voxels=args.min_voxels)
        nifti.save(labels / f"{patient}.nii.gz", inst, spacing, affine)
        save_json(
            {"instances": {str(i): 0 for i in classes}}, labels / f"{patient}.json"
        )
        n += 1
    print(f"converted {n} cases -> {out}")


if __name__ == "__main__":
    main()
