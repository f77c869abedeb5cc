"""RibFrac -> standard detection format.

The port's copy of the repository's ``projects/Task020_RibFrac/prepare.py``:
the same names, signatures and outputs, with its imports pointed at the
port.

Semantic equivalent of nnDetection's ``projects/Task020_RibFrac``: the
challenge ships CT volumes, instance-labelled fracture masks and a CSV
(``ribfrac-train-info.csv``: public_id, label_id, label_code) mapping every
instance to a fracture class (-1 ignore, 0 background, 1..4 classes). Here
label_code -1/0 instances are dropped and classes are shifted to start at 0.

Usage:
    python -m nndetection_tpu_torch.projects.Task020_RibFrac.prepare --source /data/ribfrac \
        [--out $det_data/Task020_RibFrac]
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

from nndetection_tpu_torch.data import nifti  # noqa: E402
from nndetection_tpu_torch.utils.io import save_json, save_yaml  # noqa: E402


def load_info(csv_paths) -> dict:
    mapping = defaultdict(dict)
    for p in csv_paths:
        if not Path(p).exists():
            continue
        with open(p) as f:
            for row in csv.DictReader(f):
                mapping[row["public_id"]][int(row["label_id"])] = int(
                    row["label_code"]
                )
    return mapping


def convert(source: Path, out: Path):
    source, out = Path(source), Path(out)
    info = load_info(sorted(source.glob("*info*.csv")))
    splitted = out / "raw_splitted"
    (splitted / "imagesTr").mkdir(parents=True, exist_ok=True)
    (splitted / "labelsTr").mkdir(parents=True, exist_ok=True)
    save_yaml(
        {
            "task": out.name,
            "name": "RibFrac",
            "dim": 3,
            "target_class": None,
            "test_labels": False,
            # reference trains fg/bg on RibFrac (fracture classes are noisy)
            "labels": {"0": "fracture"},
            "modalities": {"0": "CT"},
        },
        out / "dataset.yaml",
    )
    n = 0
    for img_path in sorted(source.rglob("*-image.nii.gz")):
        cid = img_path.name[: -len("-image.nii.gz")]
        label_path = img_path.parent / f"{cid}-label.nii.gz"
        if not label_path.exists():
            matches = list(source.rglob(f"{cid}-label.nii.gz"))
            if not matches:
                continue
            label_path = matches[0]
        data, spacing, affine = nifti.load(img_path)
        seg, lsp, laff = nifti.load(label_path)
        seg = np.rint(seg).astype(np.int16)
        codes = info.get(cid, {})
        out_seg = np.zeros_like(seg)
        instances = {}
        nid = 1
        for iid in (int(v) for v in np.unique(seg) if v > 0):
            code = codes.get(iid, 1)
            if code in (-1, 0):  # ignore / background codes
                continue
            out_seg[seg == iid] = nid
            instances[str(nid)] = 0  # fg/bg task
            nid += 1
        nifti.save(splitted / "imagesTr" / f"{cid}_0000.nii.gz", data, spacing, affine)
        nifti.save(splitted / "labelsTr" / f"{cid}.nii.gz", out_seg, lsp, laff)
        save_json({"instances": instances}, splitted / "labelsTr" / f"{cid}.json")
        n += 1
    print(f"converted {n} cases -> {out}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--source", required=True)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    out = Path(a.out) if a.out else Path(os.environ.get("det_data", ".")) / "Task020_RibFrac"
    convert(Path(a.source), out)


if __name__ == "__main__":
    main()
