"""Dataset-preparation helpers shared by the ``projects/`` converters.

The port's copy of :mod:`nndetection_tpu.data.prepare`: the same names,
signatures and outputs, with its imports pointed at the port.

Semantic equivalents of the reference's conversion utilities
(nnDetection's ``nndet/io/prepare.py`` and
nnDetection's ``nndet/utils/clustering.py``): turning semantic
segmentations into connected-component instance maps with a per-instance
class mapping, class removal/reordering, and carving an artificial test
split out of ``raw_splitted``.  Implemented against this repo's own IO stack
(:mod:`nndetection_tpu_torch.data.nifti`), NumPy + ``scipy.ndimage`` only.
"""
from __future__ import annotations

import random
import shutil
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from nndetection_tpu_torch.data import nifti
from nndetection_tpu_torch.utils.io import save_json


def remove_classes(
    seg: np.ndarray, rm_classes: Sequence[int], background: int = 0
) -> np.ndarray:
    """Map the given semantic classes to ``background`` and compact the
    remaining class ids downward so they stay contiguous (reference
    ``utils/clustering.py:remove_classes`` behavior)."""
    seg = seg.copy()
    for cls in sorted(int(c) for c in rm_classes):
        seg[seg == cls] = background
    kept = sorted(int(c) for c in np.unique(seg) if c != background)
    out = np.full_like(seg, background)
    for new_idx, cls in enumerate(kept, start=1):
        out[seg == cls] = new_idx
    return out


def reorder_classes(seg: np.ndarray, class_mapping: Dict[int, int]) -> np.ndarray:
    """Relabel semantic classes via an explicit old->new mapping."""
    out = seg.copy()
    for old, new in class_mapping.items():
        out[seg == int(old)] = int(new)
    return out


def seg_to_instances(
    seg: np.ndarray, min_voxels: int = 0
) -> Tuple[np.ndarray, Dict[int, int]]:
    """Split a semantic segmentation into connected-component instances.

    Returns ``(instance_map, {instance_id: semantic_class})`` with instance
    ids starting at 1 and semantic classes kept 1-based (callers subtract
    one for the detection contract, mirroring the reference's
    ``subtract_one_of_classes``).
    """
    instance_map = np.zeros(seg.shape, dtype=np.int32)
    classes: Dict[int, int] = {}
    next_id = 1
    for cls in sorted(int(c) for c in np.unique(seg) if c > 0):
        comps, n = ndimage.label(seg == cls)
        for comp in range(1, n + 1):
            mask = comps == comp
            if min_voxels and int(mask.sum()) < min_voxels:
                continue
            instance_map[mask] = next_id
            classes[next_id] = cls
            next_id += 1
    return instance_map, classes


def instances_from_segmentation(
    source_file: Path,
    output_dir: Path,
    rm_classes: Optional[Sequence[int]] = None,
    ro_classes: Optional[Dict[int, int]] = None,
    subtract_one_of_classes: bool = True,
    fg_vs_bg: bool = False,
    file_name: Optional[str] = None,
    min_voxels: int = 0,
) -> Dict[int, int]:
    """Convert a semantic segmentation file into the instance contract.

    Reads ``source_file`` (NIfTI), optionally removes/reorders classes,
    splits into connected components, optionally collapses every foreground
    class to 0 (``fg_vs_bg``), and writes ``<name>.nii.gz`` (instance map)
    plus ``<name>.json`` (``{"instances": {id: class}}``) into
    ``output_dir``.  Matches the reference converter helper used by e.g.
    the ADAM script (``projects/Task019_ADAM/scripts/prepare.py``).
    """
    seg, spacing, affine = nifti.load(source_file)
    seg = np.rint(seg).astype(np.int32)
    if rm_classes:
        seg = remove_classes(seg, rm_classes)
    if ro_classes:
        seg = reorder_classes(seg, ro_classes)
    if fg_vs_bg:
        seg = (seg > 0).astype(np.int32)
    instance_map, classes = seg_to_instances(seg, min_voxels=min_voxels)
    if fg_vs_bg:
        mapping = {iid: 0 for iid in classes}
    elif subtract_one_of_classes:
        mapping = {iid: cls - 1 for iid, cls in classes.items()}
    else:
        mapping = dict(classes)

    if file_name is None:
        name = Path(source_file).name
        for suffix in (".nii.gz", ".nii", ".mhd", ".nrrd"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
                break
        file_name = name
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    nifti.save(output_dir / f"{file_name}.nii.gz", instance_map, spacing, affine)
    save_json(
        {"instances": {str(k): int(v) for k, v in mapping.items()}},
        output_dir / f"{file_name}.json",
    )
    return mapping


def create_test_split(
    splitted_dir: Path,
    num_modalities: int = 1,
    test_size: float = 0.3,
    random_state: int = 0,
    shuffle: bool = True,
) -> Sequence[str]:
    """Move a random fraction of ``imagesTr``/``labelsTr`` into
    ``imagesTs``/``labelsTs`` (reference ``io/prepare.py:create_test_split``).

    Returns the chosen test case ids.
    """
    splitted_dir = Path(splitted_dir)
    images_tr = splitted_dir / "imagesTr"
    labels_tr = splitted_dir / "labelsTr"
    images_ts = splitted_dir / "imagesTs"
    labels_ts = splitted_dir / "labelsTs"
    images_ts.mkdir(parents=True, exist_ok=True)
    labels_ts.mkdir(parents=True, exist_ok=True)

    case_ids = sorted(
        p.name[: -len("_0000.nii.gz")]
        for p in images_tr.glob("*_0000.nii.gz")
    )
    if shuffle:
        rng = random.Random(random_state)
        rng.shuffle(case_ids)
    n_test = int(round(len(case_ids) * test_size))
    test_ids = sorted(case_ids[:n_test])

    for cid in test_ids:
        for mod in range(num_modalities):
            src = images_tr / f"{cid}_{mod:04d}.nii.gz"
            shutil.move(str(src), str(images_ts / src.name))
        for ext in (".nii.gz", ".json"):
            src = labels_tr / f"{cid}{ext}"
            if src.exists():
                shutil.move(str(src), str(labels_ts / src.name))
    return test_ids
