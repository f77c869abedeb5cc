"""nnU-Net interoperability (reference ``scripts/nnunet/`` +
``nndet/utils/nnunet.py:36-178``):

* ``export``: write a detection task as an nnU-Net-format semantic
  segmentation task (instances collapsed to their classes).
* ``boxes``: convert nnU-Net softmax/argmax predictions back into detection
  boxes via connected components + mean softmax score (the "nnUNetPlus"
  baseline).

The port's copy of :mod:`nndetection_tpu.cli.nnunet_interop`: the same
names, signatures and outputs, with its imports pointed at the port. Run as
``python -m nndetection_tpu_torch.cli.nnunet_interop {export,boxes} ...``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
from scipy import ndimage

from nndetection_tpu_torch.data import nifti
from nndetection_tpu_torch.data.dataset import DatasetInfo, discover_cases
from nndetection_tpu_torch.data.instances import instances_to_boxes_np
from nndetection_tpu_torch.utils.io import save_pickle


def export_to_nnunet(task_dir, out_dir) -> None:
    task_dir, out_dir = Path(task_dir), Path(out_dir)
    info = DatasetInfo.from_file(task_dir / "dataset.yaml")
    (out_dir / "imagesTr").mkdir(parents=True, exist_ok=True)
    (out_dir / "labelsTr").mkdir(parents=True, exist_ok=True)
    cases = discover_cases(
        task_dir / "raw_splitted" / "imagesTr",
        task_dir / "raw_splitted" / "labelsTr",
        info.num_modalities,
    )
    training = []
    for c in cases:
        for img in c.images:
            target = out_dir / "imagesTr" / img.name
            if not target.exists():
                target.symlink_to(img.resolve())
        seg, sp, aff = nifti.load(c.label)
        seg = np.rint(seg).astype(np.int16)
        semantic = np.zeros_like(seg)
        for iid, cls in c.instances().items():
            semantic[seg == iid] = cls + 1
        nifti.save(out_dir / "labelsTr" / f"{c.case_id}.nii.gz", semantic, sp, aff)
        training.append(
            {
                "image": f"./imagesTr/{c.case_id}.nii.gz",
                "label": f"./labelsTr/{c.case_id}.nii.gz",
            }
        )
    dataset_json = {
        "name": info.task,
        "tensorImageSize": "3D",
        "modality": {str(k): v for k, v in info.modalities.items()},
        "labels": {
            "0": "background",
            **{str(k + 1): v for k, v in info.labels.items()},
        },
        "numTraining": len(training),
        "training": training,
        "test": [],
    }
    with open(out_dir / "dataset.json", "w") as f:
        json.dump(dataset_json, f, indent=2)
    print(f"exported {len(training)} cases -> {out_dir}")


def nnunet_seg_to_boxes(pred_dir, out_dir, min_size: float = 0.0) -> None:
    """Semantic predictions (.nii.gz, classes from 1) -> `{case}_boxes.pkl`."""
    pred_dir, out_dir = Path(pred_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(pred_dir.glob("*.nii.gz")):
        cid = p.name[: -len(".nii.gz")]
        seg, _, _ = nifti.load(p)
        seg = np.rint(seg).astype(np.int16)
        boxes, scores, labels = [], [], []
        softmax_path = pred_dir / f"{cid}.npz"
        probs = None
        if softmax_path.exists():
            with np.load(softmax_path) as f:
                probs = f[f.files[0]]
        for sem in (int(v) for v in np.unique(seg) if v > 0):
            comps, ncomp = ndimage.label(seg == sem)
            for c in range(1, ncomp + 1):
                m = comps == c
                if min_size and m.sum() < min_size:
                    continue
                bxs, _ = instances_to_boxes_np(m.astype(np.int16))
                if not len(bxs):
                    continue
                boxes.append(bxs[0])
                if probs is not None and sem < probs.shape[0]:
                    scores.append(float(probs[sem][m].mean()))
                else:
                    scores.append(1.0)
                labels.append(sem - 1)
        save_pickle(
            {
                "pred_boxes": np.asarray(boxes).reshape(-1, 6),
                "pred_scores": np.asarray(scores),
                "pred_labels": np.asarray(labels, np.int64),
            },
            out_dir / f"{cid}_boxes.pkl",
        )
        n += 1
    print(f"converted {n} prediction cases -> {out_dir}")


def main() -> None:
    p = argparse.ArgumentParser(description="nnU-Net interop")
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("export")
    e.add_argument("task_dir")
    e.add_argument("out_dir")
    b = sub.add_parser("boxes")
    b.add_argument("pred_dir")
    b.add_argument("out_dir")
    b.add_argument("--min_size", type=float, default=0.0)
    a = p.parse_args()
    if a.cmd == "export":
        export_to_nnunet(a.task_dir, a.out_dir)
    else:
        nnunet_seg_to_boxes(a.pred_dir, a.out_dir, a.min_size)


if __name__ == "__main__":
    main()
