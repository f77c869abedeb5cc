"""Synthetic toy dataset: bright cubes vs hollow cubes, 2 classes.

Copy of :mod:`nndetection_tpu.data.example`: nnDetection's toy task, on
which a trained model should be near perfect. Volume size is configurable so CI-scale tests can
use small cases.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from nndetection_tpu_torch.data import nifti
from nndetection_tpu_torch.utils.io import save_json, save_yaml


def generate_case(
    rng: np.random.RandomState,
    image_size: Sequence[int] = (64, 64, 64),
    object_size: Sequence[int] = (8, 16),
    object_width: int = 2,
):
    """One synthetic case -> (data, instance_mask, instance_class)."""
    dim = len(image_size)
    size = rng.randint(object_size[0], object_size[1])
    cls = rng.randint(0, 2)
    data = rng.rand(*image_size).astype(np.float32)
    mask = np.zeros(image_size, dtype=np.uint8)
    top_left = [rng.randint(0, image_size[i] - size) for i in range(dim)]
    slicing = tuple(slice(tp, tp + size) for tp in top_left)
    if cls == 0:
        data[slicing] += 0.4
        mask[slicing] = 1
    else:
        inner = [slice(tp + object_width, tp + size - object_width) for tp in top_left]
        inner[0] = slice(0, image_size[0])
        obj = np.zeros_like(mask, dtype=bool)
        obj[slicing] = True
        obj[tuple(inner)] = False
        data[obj] += 0.4
        mask[obj] = 1
    data = data.clip(0, 1)
    return data, mask, cls


def generate_example_dataset(
    task_dir,
    num_train: int = 10,
    num_test: int = 10,
    image_size: Sequence[int] = (64, 64, 64),
    object_size: Sequence[int] = (8, 16),
    object_width: int = 2,
    seed_offset: int = 0,
    spacing: Optional[Sequence[float]] = None,
) -> Path:
    """Write a full toy task in the standard ``raw_splitted`` contract.

    ``spacing`` (z, y, x; default isotropic 1mm) is written into the NIfTI
    headers — an anisotropic value (e.g. ``(4, 1, 1)``) drives the planner's
    anisotropy rules (10th-percentile target spacing, dummy-2D augmentation,
    separate-z resampling)."""
    task_dir = Path(task_dir)
    splitted = task_dir / "raw_splitted"
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs"):
        (splitted / sub).mkdir(parents=True, exist_ok=True)

    save_yaml(
        {
            "task": task_dir.name,
            "name": "Example",
            "dim": len(image_size),
            "target_class": None,
            "test_labels": True,
            "labels": {"0": "square", "1": "hollow_square"},
            "modalities": {"0": "synthetic"},
        },
        task_dir / "dataset.yaml",
    )

    def write(idx: int, images_dir: Path, labels_dir: Path):
        rng = np.random.RandomState(idx + seed_offset)
        data, mask, cls = generate_case(rng, image_size, object_size, object_width)
        cid = f"case_{idx}"
        sp = np.asarray(spacing, np.float64) if spacing is not None else None
        nifti.save(images_dir / f"{cid}_0000.nii.gz", data, spacing=sp)
        nifti.save(labels_dir / f"{cid}.nii.gz", mask, spacing=sp)
        save_json({"instances": {"1": cls}}, labels_dir / f"{cid}.json")

    for i in range(num_train):
        write(i, splitted / "imagesTr", splitted / "labelsTr")
    for i in range(num_test):
        write(num_train + i, splitted / "imagesTs", splitted / "labelsTs")
    return task_dir
