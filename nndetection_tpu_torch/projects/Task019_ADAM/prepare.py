"""ADAM (intracranial aneurysm detection, MICCAI 2020) -> standard format.

The port's copy of the repository's ``projects/Task019_ADAM/prepare.py``:
the same names, signatures and outputs, with its imports pointed at the
port.

Semantic equivalent of nnDetection's ``projects/Task019_ADAM``: each
subject directory holds a bias-corrected structural image
(``pre/struct_aligned.nii.gz``), a TOF angiography image (``pre/TOF.nii.gz``)
and a semantic ``aneurysms.nii.gz`` (1=untreated aneurysm, 2=treated/coiled).
Run as foreground-vs-background: all foreground collapses to one class, then
connected components become instances of class 0.  Two input modalities.

Usage:
    python -m nndetection_tpu_torch.projects.Task019_ADAM.prepare \
        --source /data/ADAM_release_subjs \
        [--out $det_data/Task019FG_ADAM]
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from nndetection_tpu_torch.data.prepare import instances_from_segmentation  # noqa: E402
from nndetection_tpu_torch.utils.io import save_yaml  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--source", required=True, help="ADAM_release_subjs root")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    source = Path(args.source)
    out = Path(args.out or Path(os.environ.get("det_data", ".")) / "Task019FG_ADAM")
    images = out / "raw_splitted" / "imagesTr"
    labels = out / "raw_splitted" / "labelsTr"
    images.mkdir(parents=True, exist_ok=True)
    labels.mkdir(parents=True, exist_ok=True)

    save_yaml(
        {
            "task": "Task019FG_ADAM",
            "name": "ADAM",
            "dim": 3,
            "modalities": {0: "Structured", 1: "TOF"},
            "labels": {0: "aneurysm"},
            "target_class": None,
            "test_labels": False,
        },
        out / "dataset.yaml",
    )

    n = 0
    for subj in sorted(p for p in source.iterdir() if p.is_dir()):
        struct = subj / "pre" / "struct_aligned.nii.gz"
        tof = subj / "pre" / "TOF.nii.gz"
        mask = subj / "aneurysms.nii.gz"
        if not (struct.exists() and tof.exists() and mask.exists()):
            print(f"skip {subj.name}: missing files")
            continue
        shutil.copy(struct, images / f"{subj.name}_0000.nii.gz")
        shutil.copy(tof, images / f"{subj.name}_0001.nii.gz")
        instances_from_segmentation(
            mask, labels, fg_vs_bg=True, file_name=subj.name
        )
        n += 1
    print(f"converted {n} cases -> {out}")


if __name__ == "__main__":
    main()
