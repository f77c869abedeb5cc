"""CADA (cerebral aneurysm detection) -> standard detection format.

The port's copy of the repository's ``projects/Task017_CADA/prepare.py``:
the same names, signatures and outputs, with its imports pointed at the
port.

Semantic equivalent of nnDetection's ``projects/Task017_CADA``: the
challenge ships ``train_dataset/<case>_orig.nii.gz`` angiography volumes and
``train_mask_images/<case>_labeledMasks.nii.gz`` masks that are ALREADY
instance-labelled (1..N per aneurysm), so the converter only renames files
into the contract and writes an all-class-0 instance mapping.

Usage:
    python -m nndetection_tpu_torch.projects.Task017_CADA.prepare --source /data/CADA \
        [--out $det_data/Task017_CADA]
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from nndetection_tpu_torch.data import nifti  # noqa: E402
from nndetection_tpu_torch.utils.io import save_json, save_yaml  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument(
        "--source",
        required=True,
        help="CADA root (train_dataset/, train_mask_images/)",
    )
    p.add_argument("--out", default=None)
    args = p.parse_args()

    source = Path(args.source)
    data_dir = source / "train_dataset"
    mask_dir = source / "train_mask_images"
    out = Path(args.out or Path(os.environ.get("det_data", ".")) / "Task017_CADA")
    images = out / "raw_splitted" / "imagesTr"
    labels = out / "raw_splitted" / "labelsTr"
    images.mkdir(parents=True, exist_ok=True)
    labels.mkdir(parents=True, exist_ok=True)

    save_yaml(
        {
            "task": "Task017_CADA",
            "name": "CADA",
            "dim": 3,
            "modalities": {0: "CT"},
            "labels": {0: "aneurysm"},
            "target_class": None,
            "test_labels": False,
        },
        out / "dataset.yaml",
    )

    n = 0
    for img_path in sorted(data_dir.glob("*_orig.nii.gz")):
        cid = img_path.name[: -len("_orig.nii.gz")]
        mask_path = mask_dir / f"{cid}_labeledMasks.nii.gz"
        if not mask_path.exists():
            print(f"skip {cid}: no mask")
            continue
        shutil.copy(img_path, images / f"{cid}_0000.nii.gz")
        shutil.copy(mask_path, labels / f"{cid}.nii.gz")
        mask, _, _ = nifti.load(mask_path)
        n_inst = int(np.rint(mask.max()))
        save_json(
            {"instances": {str(i): 0 for i in range(1, n_inst + 1)}},
            labels / f"{cid}.json",
        )
        n += 1
    print(f"converted {n} cases -> {out}")


if __name__ == "__main__":
    main()
