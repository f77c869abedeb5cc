"""KiTS19 -> standard detection format.

The port's copy of the repository's ``projects/Task011_Kits/prepare.py``:
the same names, signatures and outputs, with its imports pointed at the
port.

Semantic equivalent of nnDetection's ``projects/Task011_Kits`` (kidney
tumour detection): each training case directory ships ``imaging.nii.gz`` and
a semantic ``segmentation.nii.gz`` with kidney=1 (context/"stuff") and
tumour=2 (the detection target/"thing").  The reference copies the semantic
mask and defers the stuff/things split to its prep stage; this framework's
label contract is instance maps, so the converter performs the split here:
kidney is dropped from detection, tumour connected components become
instances of class 0.  Cases >= 210 (the unlabeled test cohort) are skipped
and an artificial 30% test split is carved out, as in the reference.

Usage:
    python -m nndetection_tpu_torch.projects.Task011_Kits.prepare --source /data/kits19/data \
        [--out $det_data/Task011_Kits] [--min-voxels 3]
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from nndetection_tpu_torch.data.prepare import (  # noqa: E402
    create_test_split,
    instances_from_segmentation,
)
from nndetection_tpu_torch.utils.io import save_yaml  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--source", required=True, help="kits19 data root (case_00000/, ...)")
    p.add_argument("--out", default=None)
    p.add_argument("--min-voxels", type=int, default=3)
    p.add_argument("--test-size", type=float, default=0.3)
    args = p.parse_args()

    source = Path(args.source)
    out = Path(args.out or Path(os.environ.get("det_data", ".")) / "Task011_Kits")
    splitted = out / "raw_splitted"
    images = splitted / "imagesTr"
    labels = splitted / "labelsTr"
    images.mkdir(parents=True, exist_ok=True)
    labels.mkdir(parents=True, exist_ok=True)

    save_yaml(
        {
            "task": "Task011_Kits",
            "name": "Kits",
            "dim": 3,
            "modalities": {0: "CT"},
            "labels": {0: "tumour"},
            "target_class": None,
            "test_labels": True,
        },
        out / "dataset.yaml",
    )

    n = 0
    for case_dir in sorted(source.glob("case_*")):
        if not case_dir.is_dir():
            continue
        case_id = int(case_dir.name.split("_")[-1])
        if case_id >= 210:  # unlabeled test cohort
            continue
        img = case_dir / "imaging.nii.gz"
        seg = case_dir / "segmentation.nii.gz"
        if not img.exists() or not seg.exists():
            continue
        shutil.copy(img, images / f"{case_dir.name}_0000.nii.gz")
        # kidney (1) is context only; tumour (2) -> instances of class 0
        instances_from_segmentation(
            seg,
            labels,
            rm_classes=[1],
            subtract_one_of_classes=True,
            file_name=case_dir.name,
            min_voxels=args.min_voxels,
        )
        n += 1

    test_ids = create_test_split(
        splitted, num_modalities=1, test_size=args.test_size, random_state=0
    )
    print(f"converted {n} cases ({len(test_ids)} moved to test split) -> {out}")


if __name__ == "__main__":
    main()
