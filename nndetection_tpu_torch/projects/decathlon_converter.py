"""Generic Medical-Segmentation-Decathlon-style converter.

The port's copy of the repository's ``projects/decathlon_converter.py``: the
same names, signatures and outputs, with its imports pointed at the port.

Covers the reference's Decathlon-family tasks (Task003_Liver,
Task007_Pancreas, Task008_HepaticVessel, Task010_Colon, ... —
nnDetection's ``projects/``): an MSD task directory
(``imagesTr/*.nii.gz``, ``labelsTr/*.nii.gz``, ``dataset.json`` with semantic
labels) is converted to the detection contract by connected-component
splitting of the semantic segmentation.

Usage:
    python -m nndetection_tpu_torch.projects.decathlon_converter --source /data/Task03_Liver \
        --out $det_data/Task003_Liver [--target-labels 2]  # e.g. tumour only
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
from scipy import ndimage

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from nndetection_tpu_torch.data import nifti  # noqa: E402
from nndetection_tpu_torch.utils.io import save_json, save_yaml  # noqa: E402


def convert(source: Path, out: Path, target_labels=None, min_size: float = 0.0):
    source, out = Path(source), Path(out)
    with open(source / "dataset.json") as f:
        meta = json.load(f)
    sem_labels = {int(k): v for k, v in meta.get("labels", {}).items() if int(k) > 0}
    if target_labels:
        sem_labels = {k: v for k, v in sem_labels.items() if k in target_labels}
    label_to_class = {sem: i for i, sem in enumerate(sorted(sem_labels))}
    modalities = {int(k): v for k, v in meta.get("modality", {"0": "CT"}).items()}

    splitted = out / "raw_splitted"
    for split, img_sub, lab_sub in (
        ("Tr", "imagesTr", "labelsTr"),
        ("Ts", "imagesTs", None),
    ):
        src_imgs = source / img_sub
        if not src_imgs.is_dir():
            continue
        img_out = splitted / f"images{split}"
        lab_out = splitted / f"labels{split}"
        img_out.mkdir(parents=True, exist_ok=True)
        lab_out.mkdir(parents=True, exist_ok=True)
        for img_path in sorted(src_imgs.glob("*.nii.gz")):
            if img_path.name.startswith("."):
                continue
            cid = img_path.name[: -len(".nii.gz")]
            data, spacing, affine = nifti.load(img_path)
            if data.ndim == 4:  # multi-modality 4D MSD volumes
                for m in range(data.shape[0]):
                    nifti.save(
                        img_out / f"{cid}_{m:04d}.nii.gz", data[m], spacing, affine
                    )
            else:
                nifti.save(img_out / f"{cid}_0000.nii.gz", data, spacing, affine)
            lab_path = source / "labelsTr" / img_path.name if lab_sub else None
            if lab_path and lab_path.exists():
                seg, lsp, laff = nifti.load(lab_path)
                seg = np.rint(seg).astype(np.int32)
                instances = np.zeros_like(seg, dtype=np.int16)
                mapping = {}
                nid = 1
                for sem, cls in label_to_class.items():
                    comps, n = ndimage.label(seg == sem)
                    for c in range(1, n + 1):
                        m = comps == c
                        if min_size and m.sum() < min_size:
                            continue
                        instances[m] = nid
                        mapping[str(nid)] = cls
                        nid += 1
                nifti.save(lab_out / f"{cid}.nii.gz", instances, lsp, laff)
                save_json({"instances": mapping}, lab_out / f"{cid}.json")

    save_yaml(
        {
            "task": out.name,
            "name": meta.get("name", out.name),
            "dim": 3,
            "target_class": None,
            "test_labels": False,
            "labels": {str(c): sem_labels[s] for s, c in label_to_class.items()},
            "modalities": {str(k): v for k, v in modalities.items()},
        },
        out / "dataset.yaml",
    )
    print(f"converted {source} -> {out} (classes: {label_to_class})")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--source", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--target-labels", type=int, nargs="*", default=None)
    p.add_argument("--min-size", type=float, default=0.0)
    a = p.parse_args()
    convert(Path(a.source), Path(a.out), a.target_labels, a.min_size)


if __name__ == "__main__":
    main()
