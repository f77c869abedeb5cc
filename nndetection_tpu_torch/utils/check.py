"""Environment guard and dataset consistency checks (copy of
:mod:`nndetection_tpu.utils.check`), on the port's ``data/{dataset,nifti}.py``
and ``utils/io.py``:

* :func:`env_guard` — required env vars + thread-oversubscription warning.
* :func:`check_dataset_file` — ``dataset.yaml`` schema: required keys,
  ``dim`` in {2,3}, consecutive integer label/modality keys starting at 0,
  string names, optional integer ``target_class``.
* :func:`check_data_and_label_splitted` — raw_splitted tree consistency:
  every expected modality/label/instances-json file exists, no ``.`` in
  directory names, instance ids start at 1 and are consecutive, every
  instance class is declared in the labels map; with ``full_check`` every
  volume is loaded and image/label geometry (shape, spacing,
  origin+direction via the affine) must agree and the label volume's
  instance ids must match the json exactly.

Every check returns the full list of problems so a user can fix a dataset
in one pass; the CLI raises when the list is non-empty.
"""
from __future__ import annotations

import functools
import logging
import os
from pathlib import Path
from typing import Callable, List

import numpy as np

log = logging.getLogger("nndet")


def env_guard(fn: Callable) -> Callable:
    """Require the ``det_data``/``det_models`` environment contract before
    running an entry point; warn on thread oversubscription."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        missing = [v for v in ("det_data", "det_models") if not os.environ.get(v)]
        if missing:
            raise EnvironmentError(
                f"required environment variables not set: {missing} "
                "(export det_data=... det_models=...)"
            )
        omp = os.environ.get("OMP_NUM_THREADS")
        if omp not in (None, "1"):
            log.warning(
                "OMP_NUM_THREADS=%s — the host pipeline assumes 1 to avoid "
                "thread oversubscription", omp,
            )
        return fn(*args, **kwargs)

    return wrapper


def check_dataset_file(task_dir) -> List[str]:
    """Validate the ``dataset.yaml`` schema."""
    from nndetection_tpu_torch.utils.io import load_yaml

    task_dir = Path(task_dir)
    problems: List[str] = []
    path = task_dir / "dataset.yaml"
    if not path.exists():
        return [f"missing {path}"]
    raw = load_yaml(path)
    if not isinstance(raw, dict):
        return [f"{path}: expected a mapping, found {type(raw).__name__}"]

    for key, ktype in (("task", str), ("dim", int), ("labels", dict),
                       ("modalities", dict)):
        if key not in raw:
            problems.append(f"dataset.yaml: missing required key '{key}'")
        elif not isinstance(raw[key], ktype):
            problems.append(
                f"dataset.yaml: key '{key}' must be {ktype.__name__}, "
                f"found {type(raw[key]).__name__}"
            )
    dim = raw.get("dim")
    if isinstance(dim, int) and dim not in (2, 3):
        problems.append(f"dataset.yaml: dim must be 2 or 3, found {dim}")

    for section in ("labels", "modalities"):
        mapping = raw.get(section)
        if not isinstance(mapping, dict):
            continue
        keys = []
        for k, v in mapping.items():
            try:
                keys.append(int(k))
            except (TypeError, ValueError):
                problems.append(
                    f"dataset.yaml: {section} key {k!r} is not an integer id"
                )
            if not isinstance(v, str):
                problems.append(
                    f"dataset.yaml: {section}[{k!r}] name must be a string, "
                    f"found {type(v).__name__}"
                )
        if sorted(keys) != list(range(len(keys))):
            problems.append(
                f"dataset.yaml: {section} ids must be consecutive from 0, "
                f"found {sorted(keys)}"
            )
    target_class = raw.get("target_class")
    if target_class is not None and not isinstance(target_class, int):
        problems.append(
            "dataset.yaml: target_class must be an integer when set, found "
            f"{type(target_class).__name__}"
        )
    return problems


def check_data_and_label_splitted(
    task_dir,
    test: bool = False,
    labels: bool = True,
    full_check: bool = False,
) -> List[str]:
    """Validate the raw_splitted tree; ``full_check`` adds the geometry
    tier."""
    from nndetection_tpu_torch.data.dataset import DatasetInfo, discover_cases

    task_dir = Path(task_dir)
    problems: List[str] = []
    info = DatasetInfo.from_file(task_dir / "dataset.yaml")
    suffix = "Ts" if test else "Tr"
    image_dir = task_dir / "raw_splitted" / f"images{suffix}"
    label_dir = task_dir / "raw_splitted" / f"labels{suffix}" if labels else None
    if not image_dir.is_dir():
        return [f"missing directory {image_dir}"]
    if "." in image_dir.parent.parent.name:
        # '.' inside task/tree names breaks case-id parsing on suffix splits
        problems.append(f"avoid '.' in dataset paths: {image_dir}")

    cases = discover_cases(image_dir, label_dir)
    if not cases:
        problems.append(f"no cases found in {image_dir}")
    for c in cases:
        if len(c.images) != info.num_modalities:
            problems.append(
                f"{c.case_id}: {len(c.images)} modality files, dataset.yaml "
                f"declares {info.num_modalities}"
            )
        if label_dir is None:
            continue
        if c.label is None:
            problems.append(f"{c.case_id}: missing label volume")
            continue
        if c.label_json is None:
            problems.append(f"{c.case_id}: missing instances json")
            continue
        problems.extend(_check_instances_json(c, info))
        if full_check:
            problems.extend(_full_geometry_check(c))
    return problems


def _check_instances_json(case, info) -> List[str]:
    """Schema + semantics of the per-case instances json: string ids mapping
    to integer classes declared in the labels map; ids start at 1 and are
    consecutive."""
    from nndetection_tpu_torch.utils.io import load_json

    problems: List[str] = []
    raw = load_json(case.label_json).get("instances", {})
    ids = []
    for k, v in raw.items():
        if not isinstance(k, str):
            problems.append(
                f"{case.case_id}: instance id {k!r} must be a string"
            )
        try:
            ids.append(int(k))
        except (TypeError, ValueError):
            problems.append(
                f"{case.case_id}: instance id {k!r} is not an integer string"
            )
            continue
        if isinstance(v, bool) or not isinstance(v, int):
            problems.append(
                f"{case.case_id}: instance {k} class must be an int, found "
                f"{type(v).__name__}"
            )
        elif v not in info.labels:
            problems.append(
                f"{case.case_id}: instance {k} class {v} not declared in "
                f"dataset.yaml labels {sorted(info.labels)}"
            )
    if ids and sorted(ids) != list(range(1, len(ids) + 1)):
        problems.append(
            f"{case.case_id}: instance ids must be consecutive starting at 1, "
            f"found {sorted(ids)}"
        )
    return problems


def _full_geometry_check(case) -> List[str]:
    """Load every modality + the label and require identical geometry
    (shape, spacing, affine = origin+direction), and exact agreement between
    the label volume's instance ids and the json."""
    from nndetection_tpu_torch.data import nifti

    problems: List[str] = []
    ref_img, ref_spacing, ref_affine = nifti.load(case.images[0])
    for p in case.images[1:]:
        img, spacing, affine = nifti.load(p)
        if img.shape != ref_img.shape:
            problems.append(
                f"{case.case_id}: modality {p.name} shape {img.shape} != "
                f"{case.images[0].name} {ref_img.shape}"
            )
        if not np.allclose(spacing, ref_spacing, atol=1e-4):
            problems.append(
                f"{case.case_id}: modality {p.name} spacing {spacing} != "
                f"{ref_spacing}"
            )
        if not np.allclose(affine, ref_affine, atol=1e-3):
            problems.append(
                f"{case.case_id}: modality {p.name} origin/direction differs "
                f"(affine mismatch)"
            )
    seg, lspacing, laffine = nifti.load(case.label)
    if seg.shape != ref_img.shape:
        problems.append(
            f"{case.case_id}: image {ref_img.shape} vs label {seg.shape}"
        )
    if not np.allclose(lspacing, ref_spacing, atol=1e-4):
        problems.append(
            f"{case.case_id}: spacing mismatch {ref_spacing} vs {lspacing}"
        )
    if not np.allclose(laffine, ref_affine, atol=1e-3):
        problems.append(
            f"{case.case_id}: label origin/direction differs from image "
            f"(affine mismatch)"
        )
    mask_ids = {int(v) for v in np.unique(seg) if v > 0}
    declared = set(case.instances().keys())
    if mask_ids - declared:
        problems.append(
            f"{case.case_id}: instances {sorted(mask_ids - declared)} present "
            "in the label volume but missing from the json"
        )
    if declared - mask_ids:
        problems.append(
            f"{case.case_id}: instances {sorted(declared - mask_ids)} declared "
            "in the json but absent from the label volume"
        )
    return problems


def check_data_and_label_consistency(task_dir, full: bool = False) -> List[str]:
    """Composite pre-prep check: dataset.yaml schema + raw_splitted
    consistency for the train split (and the test split when present).
    ``full`` adds the geometry tier (``--full_check``)."""
    task_dir = Path(task_dir)
    problems = check_dataset_file(task_dir)
    problems += check_data_and_label_splitted(
        task_dir, test=False, labels=True, full_check=full
    )
    if (task_dir / "raw_splitted" / "imagesTs").is_dir():
        from nndetection_tpu_torch.data.dataset import DatasetInfo

        info = DatasetInfo.from_file(task_dir / "dataset.yaml")
        has_ts_labels = (
            info.test_labels
            and (task_dir / "raw_splitted" / "labelsTs").is_dir()
        )
        problems += check_data_and_label_splitted(
            task_dir, test=True, labels=has_ts_labels, full_check=full
        )
    return problems
