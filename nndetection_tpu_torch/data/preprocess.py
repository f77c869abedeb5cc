"""Preprocessing stages: crop -> analyze -> process.

Copy of :mod:`nndetection_tpu.data.preprocess`, on the host in NumPy and
SciPy; the directory contract and the stages are nnDetection's:

* crop: ``raw_splitted`` -> ``raw_cropped/{case}.npz`` (data+seg stacked) +
  ``{case}.pkl`` props (crop bbox, spacing, itk meta, instance classes)
* analyze: ``preprocessed/properties/dataset_properties.pkl`` — sizes/
  spacings, fg intensity stats, instance boxes/classes
* process: resample to target spacing + normalize ->
  ``preprocessed/{plan}/imagesTr/{case}.npz`` + ``{case}_boxes.pkl``
  fg-sampling candidates + ``labelsTr/{case}_boxes_gt.npz`` eval GT

Host CPU parallelism via ``multiprocessing.Pool`` (its default start
method) when ``num_workers > 0``: the workers touch only NumPy and SciPy.
"""
from __future__ import annotations

import multiprocessing as mp
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from nndetection_tpu_torch.data import nifti
from nndetection_tpu_torch.data.crop import crop_to_nonzero
from nndetection_tpu_torch.core.boxes.ops_np import permute_boxes_np
from nndetection_tpu_torch.data.dataset import Case
from nndetection_tpu_torch.data.instances import instances_to_boxes_np
from nndetection_tpu_torch.data.normalize import normalize_case
from nndetection_tpu_torch.data.resample import resample_patient
from nndetection_tpu_torch.inference.restore import invert_transpose
from nndetection_tpu_torch.utils.io import (
    load_npz_looped,
    load_pickle,
    save_pickle,
)


# ---------------------------------------------------------------------------
# crop stage
# ---------------------------------------------------------------------------
def crop_case(case: Case, out_dir: Path) -> Dict:
    """Load one raw case, crop to nonzero, save npz + props pkl."""
    modalities = []
    spacing = affine = None
    for img in case.images:
        d, sp, aff = nifti.load(img)
        modalities.append(d.astype(np.float32))
        spacing, affine = sp, aff
    data = np.stack(modalities, axis=0)

    seg = None
    instances = {}
    if case.label is not None:
        seg, _, _ = nifti.load(case.label)
        seg = np.rint(seg).astype(np.int16)
        instances = case.instances()

    data_c, seg_c, props = crop_to_nonzero(data, seg)
    props.update(
        {
            "case_id": case.case_id,
            "original_spacing": np.asarray(spacing, dtype=np.float64),
            "original_affine": affine,
            "instances": instances,
        }
    )
    out_dir.mkdir(parents=True, exist_ok=True)
    stacked = np.concatenate([data_c, seg_c[None].astype(np.float32)], axis=0)
    np.savez_compressed(out_dir / f"{case.case_id}.npz", data=stacked)
    save_pickle(props, out_dir / f"{case.case_id}.pkl")
    return props


def run_cropping(
    cases: Sequence[Case], out_dir, num_workers: int = 0
) -> List[Dict]:
    out_dir = Path(out_dir)
    if num_workers > 0:
        with mp.Pool(num_workers) as pool:
            return pool.starmap(crop_case, [(c, out_dir) for c in cases])
    return [crop_case(c, out_dir) for c in cases]


def load_cropped(cropped_dir, case_id: str):
    d = load_npz_looped(Path(cropped_dir) / f"{case_id}.npz", keys=["data"])["data"]
    props = load_pickle(Path(cropped_dir) / f"{case_id}.pkl")
    return d[:-1], d[-1].astype(np.int16), props


# ---------------------------------------------------------------------------
# analyze stage
# ---------------------------------------------------------------------------
def analyze_case(cropped_dir: Path, case_id: str, num_fg_samples: int = 10000) -> Dict:
    data, seg, props = load_cropped(cropped_dir, case_id)
    instances = props.get("instances", {})
    boxes, ids = instances_to_boxes_np(seg)
    classes = [instances.get(i, 0) for i in ids]

    fg_mask = seg > 0
    fg_voxels = {}
    for c in range(data.shape[0]):
        vals = data[c][fg_mask]
        if len(vals) > num_fg_samples:
            vals = np.random.RandomState(1234).choice(vals, num_fg_samples, replace=False)
        fg_voxels[c] = vals.astype(np.float32)

    return {
        "case_id": case_id,
        "shape": tuple(int(s) for s in seg.shape),
        "spacing": np.asarray(props["original_spacing"], dtype=np.float64),
        "size_reduction": props.get("size_reduction", 1.0),
        "boxes": boxes,
        "classes": np.asarray(classes, dtype=np.int64),
        "fg_voxels": fg_voxels,
        "num_instances": len(ids),
    }


def analyze_dataset(
    cropped_dir, case_ids: Sequence[str], num_modalities: int, num_workers: int = 0
) -> Dict:
    """Aggregate per-case properties into ``dataset_properties``
    (nnDetection's dataset properties)."""
    cropped_dir = Path(cropped_dir)
    if num_workers > 0:
        with mp.Pool(num_workers) as pool:
            per_case = pool.starmap(
                analyze_case, [(cropped_dir, cid) for cid in case_ids]
            )
    else:
        per_case = [analyze_case(cropped_dir, cid) for cid in case_ids]

    intensity = {}
    for c in range(num_modalities):
        vox = np.concatenate([pc["fg_voxels"][c] for pc in per_case]) if per_case else np.zeros(1)
        if len(vox) == 0:
            vox = np.zeros(1, dtype=np.float32)
        intensity[c] = {
            "mean": float(np.mean(vox)),
            "sd": float(np.std(vox)),
            "percentile_00_5": float(np.percentile(vox, 0.5)),
            "percentile_99_5": float(np.percentile(vox, 99.5)),
            "min": float(np.min(vox)),
            "max": float(np.max(vox)),
        }

    all_spacings = np.stack([pc["spacing"] for pc in per_case])
    all_shapes = np.stack([np.asarray(pc["shape"]) for pc in per_case])
    # instance boxes scaled to mm for anchor planning (spacing * voxels)
    boxes_mm = []
    classes = []
    for pc in per_case:
        if len(pc["boxes"]):
            sp = pc["spacing"]
            if pc["boxes"].shape[1] == 4:  # 2D (x1, y1, x2, y2)
                scale = np.asarray([sp[0], sp[1], sp[0], sp[1]])
            else:  # 3D (x1, y1, x2, y2, z1, z2)
                scale = np.asarray([sp[0], sp[1], sp[0], sp[1], sp[2], sp[2]])
            boxes_mm.append(pc["boxes"] * scale[None])
            classes.append(pc["classes"])
    return {
        "case_ids": list(case_ids),
        "per_case": {pc["case_id"]: {k: v for k, v in pc.items() if k != "fg_voxels"} for pc in per_case},
        "all_spacings": all_spacings,
        "all_shapes": all_shapes,
        "intensity_properties": intensity,
        "boxes_mm": np.concatenate(boxes_mm, 0)
        if boxes_mm
        else np.zeros((0, 2 * all_spacings.shape[1])),
        "instance_classes": np.concatenate(classes, 0) if classes else np.zeros((0,), np.int64),
        "size_reductions": np.asarray([pc["size_reduction"] for pc in per_case]),
        "class_ids": sorted(
            {int(c) for pc in per_case for c in pc["classes"].tolist()}
        ),
    }


# ---------------------------------------------------------------------------
# process stage
# ---------------------------------------------------------------------------
def process_case(
    cropped_dir: Path,
    out_images: Path,
    out_labels: Path,
    case_id: str,
    target_spacing: np.ndarray,
    transpose_forward: Sequence[int],
    normalization_schemes: Sequence[str],
    intensity_properties: Dict,
    use_nonzero_mask: bool = False,
) -> Dict:
    """Transpose -> resample -> normalize -> candidates + eval GT for one case."""
    data, seg, props = load_cropped(cropped_dir, case_id)
    instances = props.get("instances", {})

    tf = list(transpose_forward)
    data = np.transpose(data, [0] + [i + 1 for i in tf])
    seg = np.transpose(seg, tf)
    spacing = np.asarray(props["original_spacing"], dtype=np.float64)[tf]
    target = np.asarray(target_spacing, dtype=np.float64)

    # GT boxes in the original image space (untransposed, uncropped voxel
    # grid), the space ``restore_detection`` maps predictions back to
    boxes_orig, ids_orig = instances_to_boxes_np(seg)
    classes_orig = np.asarray([instances.get(i, 0) for i in ids_orig], np.int64)
    if len(boxes_orig):
        boxes_orig = permute_boxes_np(
            boxes_orig.astype(np.float64), invert_transpose(tf)
        )
        crop_bbox = props.get("crop_bbox")
        if crop_bbox is not None:
            lo = np.asarray([c[0] for c in crop_bbox], dtype=np.float64)
            dim = boxes_orig.shape[1] // 2
            # box layout: (x1, y1, x2, y2[, z1, z2])
            off = [lo[0], lo[1], lo[0], lo[1]]
            if dim == 3:
                off += [lo[2], lo[2]]
            boxes_orig = boxes_orig + np.asarray(off)[None]

    data_r, seg_r = resample_patient(data, seg, spacing, target)
    nonzero = seg_r != -1
    data_n = normalize_case(
        data_r,
        normalization_schemes,
        intensity_properties,
        nonzero_mask=nonzero,
        use_nonzero_mask=use_nonzero_mask,
    )

    boxes, ids = instances_to_boxes_np(seg_r)
    classes = np.asarray([instances.get(i, 0) for i in ids], np.int64)

    out_images.mkdir(parents=True, exist_ok=True)
    out_labels.mkdir(parents=True, exist_ok=True)
    stacked = np.concatenate([data_n, seg_r[None].astype(np.float32)], axis=0)
    np.savez_compressed(out_images / f"{case_id}.npz", data=stacked)

    candidates = {
        "boxes": boxes.astype(np.float32),
        "classes": classes,
        "instance_ids": np.asarray(ids, np.int64),
    }
    save_pickle(candidates, out_images / f"{case_id}_boxes.pkl")

    case_props = dict(props)
    case_props.update(
        {
            "spacing_after_resampling": target,
            "transpose_forward": tf,
            "shape_after_resampling": tuple(int(s) for s in seg_r.shape),
            "boxes": boxes,
            "classes": classes,
        }
    )
    save_pickle(case_props, out_images / f"{case_id}.pkl")

    np.savez_compressed(
        out_labels / f"{case_id}_boxes_gt.npz",
        boxes=boxes.astype(np.float32),
        classes=classes,
    )
    np.savez_compressed(
        out_labels / f"{case_id}_boxes_gt_orig.npz",
        boxes=boxes_orig.astype(np.float32),
        classes=classes_orig,
    )
    return case_props


def unpack_dataset(image_dir) -> None:
    """npz -> npy unpack for fast memmap reads during training
    (nnDetection's ``unpack_dataset``)."""
    image_dir = Path(image_dir)
    for npz in sorted(image_dir.glob("*.npz")):
        npy = npz.with_suffix(".npy")
        if not npy.exists():
            data = load_npz_looped(npz, keys=["data"])["data"]
            np.save(npy, data)
