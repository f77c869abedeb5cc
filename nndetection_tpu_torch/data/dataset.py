"""The dataset directory contract (copy of :mod:`nndetection_tpu.data.dataset`):
``dataset.yaml`` as :class:`DatasetInfo`, task lookup, case ids from file
names, and the raw cases of a directory (:func:`discover_cases`).

```
{det_data}/TaskXXX_Name/
    dataset.yaml            # task, dim, modalities, labels, target_class...
    raw_splitted/{imagesTr,labelsTr,imagesTs,labelsTs}/
    raw_cropped/
    preprocessed/
```
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from nndetection_tpu_torch.utils.io import load_json, load_yaml

MODALITY_RE = re.compile(r"^(.*)_(\d{4})\.nii(\.gz)?$")


@dataclass
class DatasetInfo:
    task: str
    dim: int = 3
    modalities: Dict[int, str] = field(default_factory=lambda: {0: "CT"})
    labels: Dict[int, str] = field(default_factory=lambda: {0: "lesion"})
    target_class: Optional[int] = None
    test_labels: bool = True
    seg2det_stuff: Optional[list] = None
    min_size: Optional[float] = None

    @property
    def num_classes(self) -> int:
        return len(self.labels)

    @property
    def num_modalities(self) -> int:
        return len(self.modalities)

    @classmethod
    def from_file(cls, path) -> "DatasetInfo":
        raw = load_yaml(path)
        return cls(
            task=raw.get("task", Path(path).parent.name),
            dim=int(raw.get("dim", 3)),
            modalities={int(k): v for k, v in (raw.get("modalities") or {0: "CT"}).items()},
            labels={int(k): v for k, v in (raw.get("labels") or {0: "lesion"}).items()},
            target_class=raw.get("target_class"),
            test_labels=bool(raw.get("test_labels", True)),
        )


def get_task_dir(task: str, data_root: Optional[str] = None) -> Path:
    """A task name or number -> its directory under ``det_data``."""
    root = Path(data_root or os.environ.get("det_data", "."))
    cand = root / task
    if cand.is_dir():
        return cand
    matches = [
        p for p in root.iterdir() if p.is_dir() and (
            p.name == task
            or p.name.startswith(f"Task{task}")
            or p.name.split("_")[0].lstrip("Task").lstrip("0") == str(task).lstrip("0")
        )
    ] if root.is_dir() else []
    if len(matches) == 1:
        return matches[0]
    raise FileNotFoundError(f"task {task} not found (or ambiguous) under {root}")


def case_id_from_image(path) -> str:
    m = MODALITY_RE.match(Path(path).name)
    if not m:
        raise ValueError(f"not a modality image filename: {path}")
    return m.group(1)


def case_id_from_label(path) -> str:
    name = Path(path).name
    for suffix in (".nii.gz", ".nii", ".json"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    raise ValueError(f"unexpected label filename: {path}")


@dataclass
class Case:
    case_id: str
    images: List[Path]  # one per modality, sorted
    label: Optional[Path] = None
    label_json: Optional[Path] = None

    def instances(self) -> Dict[int, int]:
        """Instance id -> class id mapping from the per-case json."""
        if self.label_json is None:
            return {}
        raw = load_json(self.label_json).get("instances", {})
        return {int(k): int(v) for k, v in raw.items()}


def discover_cases(
    image_dir, label_dir=None, num_modalities: Optional[int] = None
) -> List[Case]:
    """The cases of ``image_dir`` (``{case}_{modality:04d}.nii[.gz]``),
    sorted by id, with their label map and json from ``label_dir``."""
    image_dir = Path(image_dir)
    by_case: Dict[str, List[Path]] = {}
    for p in sorted(image_dir.glob("*.nii*")):
        cid = case_id_from_image(p)
        by_case.setdefault(cid, []).append(p)
    cases = []
    for cid, imgs in sorted(by_case.items()):
        imgs = sorted(imgs)
        if num_modalities is not None and len(imgs) != num_modalities:
            raise ValueError(
                f"case {cid}: expected {num_modalities} modalities, found {len(imgs)}"
            )
        label = label_json = None
        if label_dir is not None:
            label_dir = Path(label_dir)
            for suffix in (".nii.gz", ".nii"):
                if (label_dir / f"{cid}{suffix}").exists():
                    label = label_dir / f"{cid}{suffix}"
                    break
            if (label_dir / f"{cid}.json").exists():
                label_json = label_dir / f"{cid}.json"
        cases.append(Case(case_id=cid, images=imgs, label=label, label_json=label_json))
    return cases
