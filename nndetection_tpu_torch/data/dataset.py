"""The dataset directory contract (counterpart of the parts of
:mod:`nndetection_tpu.data.dataset` that training reads): ``dataset.yaml``
as :class:`DatasetInfo`, task lookup and case ids from file names.

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
from typing import Dict, Optional

from nndetection_tpu_torch.utils.io import load_yaml

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
