"""Dataset conversion utilities: semantic-seg -> detection and
classification -> fg/bg detection (reference ``scripts/convert_*.py``).

The port's copy of :mod:`nndetection_tpu.cli.convert`: the same names,
signatures and outputs, with its imports pointed at the port. Run as
``python -m nndetection_tpu_torch.cli.convert {seg2det,cls2fg} TASK_DIR
OUT_DIR``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
from scipy import ndimage

from nndetection_tpu_torch.data import nifti
from nndetection_tpu_torch.data.dataset import discover_cases
from nndetection_tpu_torch.utils.io import load_yaml, save_json, save_yaml


def seg2det(task_dir, out_dir, min_size: float = 0.0) -> None:
    """Split a semantic segmentation into connected-component instances
    (``nndet_seg2det``). Class of each instance = semantic label - 1."""
    task_dir, out_dir = Path(task_dir), Path(out_dir)
    info = load_yaml(task_dir / "dataset.yaml") if (task_dir / "dataset.yaml").exists() else {}
    splitted_in = task_dir / "raw_splitted"
    for split in ("Tr", "Ts"):
        img_in = splitted_in / f"images{split}"
        lab_in = splitted_in / f"labels{split}"
        if not img_in.is_dir():
            continue
        img_out = out_dir / "raw_splitted" / f"images{split}"
        lab_out = out_dir / "raw_splitted" / f"labels{split}"
        img_out.mkdir(parents=True, exist_ok=True)
        lab_out.mkdir(parents=True, exist_ok=True)
        cases = discover_cases(img_in, lab_in if lab_in.is_dir() else None)
        for case in cases:
            for img in case.images:
                target = img_out / img.name
                if not target.exists():
                    target.symlink_to(img.resolve())
            if case.label is None:
                continue
            seg, spacing, affine = nifti.load(case.label)
            seg = np.rint(seg).astype(np.int32)
            instances = np.zeros_like(seg, dtype=np.int16)
            mapping = {}
            next_id = 1
            for sem in sorted(int(v) for v in np.unique(seg) if v > 0):
                comps, n = ndimage.label(seg == sem)
                for c in range(1, n + 1):
                    m = comps == c
                    if min_size and m.sum() < min_size:
                        continue
                    instances[m] = next_id
                    mapping[str(next_id)] = sem - 1
                    next_id += 1
            nifti.save(lab_out / f"{case.case_id}.nii.gz", instances, spacing, affine)
            save_json({"instances": mapping}, lab_out / f"{case.case_id}.json")
    # dataset.yaml with shifted labels
    labels = info.get("labels") or {}
    save_yaml(
        {
            **info,
            "task": out_dir.name,
            "labels": {str(int(k) - 1): v for k, v in labels.items() if int(k) > 0}
            or {"0": "object"},
        },
        out_dir / "dataset.yaml",
    )


def cls2fg(task_dir, out_dir) -> None:
    """Collapse instance classes to a single foreground class
    (``nndet_cls2fg``); original classes stored for restoration."""
    task_dir, out_dir = Path(task_dir), Path(out_dir)
    info = load_yaml(task_dir / "dataset.yaml")
    for split in ("Tr", "Ts"):
        img_in = task_dir / "raw_splitted" / f"images{split}"
        lab_in = task_dir / "raw_splitted" / f"labels{split}"
        if not img_in.is_dir():
            continue
        img_out = out_dir / "raw_splitted" / f"images{split}"
        lab_out = out_dir / "raw_splitted" / f"labels{split}"
        img_out.mkdir(parents=True, exist_ok=True)
        lab_out.mkdir(parents=True, exist_ok=True)
        cases = discover_cases(img_in, lab_in if lab_in.is_dir() else None)
        for case in cases:
            for img in case.images:
                target = img_out / img.name
                if not target.exists():
                    target.symlink_to(img.resolve())
            if case.label is None:
                continue
            t = lab_out / case.label.name
            if not t.exists():
                t.symlink_to(case.label.resolve())
            inst = case.instances()
            save_json(
                {
                    "instances": {str(k): 0 for k in inst},
                    "original_classes": {str(k): v for k, v in inst.items()},
                },
                lab_out / f"{case.case_id}.json",
            )
    save_yaml(
        {**info, "task": out_dir.name, "labels": {"0": "fg"}},
        out_dir / "dataset.yaml",
    )


def main_seg2det() -> None:
    p = argparse.ArgumentParser(description="semantic seg -> instance detection task")
    p.add_argument("task_dir")
    p.add_argument("out_dir")
    p.add_argument("--min_size", type=float, default=0.0)
    a = p.parse_args()
    seg2det(a.task_dir, a.out_dir, a.min_size)


def main_cls2fg() -> None:
    p = argparse.ArgumentParser(description="multi-class -> fg/bg detection task")
    p.add_argument("task_dir")
    p.add_argument("out_dir")
    a = p.parse_args()
    cls2fg(a.task_dir, a.out_dir)


COMMANDS = {"seg2det": main_seg2det, "cls2fg": main_cls2fg}


def main() -> None:
    """Run the command named by the first argument."""
    name = sys.argv[1] if len(sys.argv) > 1 else None
    if name not in COMMANDS:
        raise SystemExit(f"unknown command {name!r}; known: {', '.join(COMMANDS)}")
    sys.argv = [f"{sys.argv[0]} {name}"] + sys.argv[2:]
    COMMANDS[name]()


if __name__ == "__main__":
    main()
