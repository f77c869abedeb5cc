"""LUNA16 -> standard detection format converter + CPM evaluation exporter.

The port's copy of the repository's ``projects/Task016_Luna/prepare.py``:
the same names, signatures and outputs, with its imports pointed at the
port.

Semantic equivalent of nnDetection's ``projects/Task016_Luna``: nodule
annotations (world-coordinate centers + diameters in ``annotations.csv``)
become spherical instance masks; the official 10 subsets become the CV split.
The exporter writes predictions in the LUNA evaluation-script CSV format
(seriesuid, coordX/Y/Z, probability) so the official CPM tooling applies.

Usage:
    python -m nndetection_tpu_torch.projects.Task016_Luna.prepare --source /path/LUNA16 [--out ...]
    python -m nndetection_tpu_torch.projects.Task016_Luna.prepare \
        --export-cpm PRED_DIR PROPS_DIR OUT.csv
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

from nndetection_tpu_torch.data import mhd, nifti  # noqa: E402
from nndetection_tpu_torch.utils.io import (  # noqa: E402
    load_pickle,
    save_json,
    save_pickle,
    save_yaml,
)


def load_annotations(csv_path) -> dict:
    ann = defaultdict(list)
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            ann[row["seriesuid"]].append(
                (
                    float(row["coordX"]),
                    float(row["coordY"]),
                    float(row["coordZ"]),
                    float(row["diameter_mm"]),
                )
            )
    return ann


def convert_case(mhd_path: Path, annotations, images_dir: Path, labels_dir: Path):
    data, spacing, origin = mhd.load(mhd_path)
    cid = mhd_path.stem
    mask = np.zeros(data.shape, dtype=np.uint8)
    instances = {}
    for i, (x, y, z, diam) in enumerate(annotations, start=1):
        center_kji = mhd.world_to_voxel(np.asarray([x, y, z]), origin, spacing)
        radius_vox = (diam / 2.0) / spacing  # per-axis radius in voxels
        lo = np.maximum(np.floor(center_kji - radius_vox - 1), 0).astype(int)
        hi = np.minimum(np.ceil(center_kji + radius_vox + 1), data.shape).astype(int)
        if np.any(hi <= lo):
            continue
        grids = np.meshgrid(
            *[np.arange(l, h) for l, h in zip(lo, hi)], indexing="ij"
        )
        dist = sum(
            ((g - c) * s) ** 2 for g, c, s in zip(grids, center_kji, spacing)
        )
        sphere = dist <= (diam / 2.0) ** 2
        region = tuple(slice(l, h) for l, h in zip(lo, hi))
        mask[region][sphere] = i
        instances[str(i)] = 0
    nifti.save(images_dir / f"{cid}_0000.nii.gz", data.astype(np.float32), spacing)
    nifti.save(labels_dir / f"{cid}.nii.gz", mask, spacing)
    save_json({"instances": instances}, labels_dir / f"{cid}.json")
    # persist world geometry for the CPM exporter
    save_pickle(
        {"origin": origin, "spacing": spacing, "shape": data.shape},
        labels_dir / f"{cid}_geometry.pkl",
    )


def convert(source: Path, out: Path):
    source, out = Path(source), Path(out)
    ann = load_annotations(source / "annotations.csv")
    splitted = out / "raw_splitted"
    (splitted / "imagesTr").mkdir(parents=True, exist_ok=True)
    (splitted / "labelsTr").mkdir(parents=True, exist_ok=True)
    save_yaml(
        {
            "task": out.name,
            "name": "Luna",
            "dim": 3,
            "target_class": None,
            "test_labels": False,
            "labels": {"0": "nodule"},
            "modalities": {"0": "CT"},
        },
        out / "dataset.yaml",
    )
    subset_of = {}
    for subset_dir in sorted(source.glob("subset*")):
        for p in sorted(subset_dir.glob("*.mhd")):
            subset_of[p.stem] = int(subset_dir.name.replace("subset", ""))
            convert_case(
                p, ann.get(p.stem, []), splitted / "imagesTr", splitted / "labelsTr"
            )
    save_json(subset_of, out / "luna_subsets.json")
    print(f"converted {len(subset_of)} cases -> {out}")


def export_cpm(pred_dir: Path, labels_dir: Path, out_csv: Path, score_thresh=0.0):
    """Export restored box predictions as LUNA CPM csv (box center -> world)."""
    rows = []
    for p in sorted(Path(pred_dir).glob("*_boxes.pkl")):
        cid = p.name[: -len("_boxes.pkl")]
        # only real cases carry a geometry pkl; anything else matched by the
        # glob (e.g. the evaluator's results_boxes.pkl summary) is skipped
        if not (Path(labels_dir) / f"{cid}_geometry.pkl").exists():
            if cid != "results":
                print(f"export_cpm: skipping {p.name} (no geometry pkl)")
            continue
        pred = load_pickle(p)
        geom = load_pickle(Path(labels_dir) / f"{cid}_geometry.pkl")
        origin, spacing = geom["origin"], geom["spacing"]
        boxes = np.asarray(pred["pred_boxes"], dtype=np.float64)
        scores = np.asarray(pred["pred_scores"])
        for b, s in zip(boxes, scores):
            if s < score_thresh:
                continue
            center_kji = np.asarray(
                [(b[0] + b[2]) / 2, (b[1] + b[3]) / 2, (b[4] + b[5]) / 2]
            )
            world_xyz = center_kji[::-1] * spacing[::-1] + origin
            rows.append([cid, *world_xyz.tolist(), float(s)])
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["seriesuid", "coordX", "coordY", "coordZ", "probability"])
        w.writerows(rows)
    print(f"wrote {len(rows)} predictions -> {out_csv}")


FPPI_POINTS = (0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0)


def score_cpm(pred_csv, annotations_csv, num_scans=None, series=None):
    """Score a CPM-format prediction csv against ``annotations.csv`` with the
    official LUNA16 FROC semantics (``evaluationScript/noduleCADEvaluation``):
    a candidate is a hit when its center lies within ``diameter/2`` of an
    annotation center; every hit is removed from the FP pool; an annotation's
    detection probability is the max over its hits; sensitivity is
    interpolated at FPPI {1/8, 1/4, 1/2, 1, 2, 4, 8}; CPM = mean sensitivity.

    ``num_scans`` must be the TOTAL number of scored scans (scans without
    predictions or annotations still count toward the FP-per-scan rate).

    ``series`` mirrors the official script's ``seriesuids.csv``: when given,
    only those scans are evaluated — annotations and predictions on other
    scans are dropped (required when scoring a CV fold subset, else every
    unscanned scan's nodules would count as misses) — and ``num_scans``
    defaults to ``len(series)``.
    """
    ann = load_annotations(annotations_csv)
    preds = defaultdict(list)
    with open(pred_csv) as f:
        for row in csv.DictReader(f):
            preds[row["seriesuid"]].append(
                (float(row["coordX"]), float(row["coordY"]),
                 float(row["coordZ"]), float(row["probability"]))
            )
    if series is not None:
        series = set(series)
        ann = {k: v for k, v in ann.items() if k in series}
        preds = defaultdict(list, {k: v for k, v in preds.items() if k in series})
        if num_scans is None:
            num_scans = len(series)
    if num_scans is None:
        num_scans = len(set(preds) | set(ann))

    hit_probs = []  # best prob per annotation (-inf if missed)
    fp_probs = []
    for cid in set(preds) | set(ann):
        cand = np.asarray(preds.get(cid, []), np.float64).reshape(-1, 4)
        nodules = np.asarray(ann.get(cid, []), np.float64).reshape(-1, 4)
        if len(nodules) == 0:
            fp_probs.extend(cand[:, 3].tolist())
            continue
        if len(cand) == 0:
            hit_probs.extend([-np.inf] * len(nodules))
            continue
        d2 = (
            (cand[:, None, :3] - nodules[None, :, :3]) ** 2
        ).sum(-1)  # [cand, nodule]
        within = d2 <= (nodules[None, :, 3] / 2.0) ** 2
        for j in range(len(nodules)):
            hits = cand[within[:, j], 3]
            hit_probs.append(float(hits.max()) if len(hits) else -np.inf)
        fp_probs.extend(cand[~within.any(axis=1), 3].tolist())

    hit_probs = np.asarray(hit_probs)
    fp_probs = np.asarray(sorted(fp_probs))
    n_ann = len(hit_probs)
    thresholds = np.unique(
        np.concatenate([hit_probs[np.isfinite(hit_probs)], fp_probs])
    )[::-1]
    if n_ann == 0 or len(thresholds) == 0:
        return {"cpm": 0.0, "froc": {str(f): 0.0 for f in FPPI_POINTS}}
    sens = [(hit_probs >= t).mean() for t in thresholds]
    fppi = [
        (len(fp_probs) - np.searchsorted(fp_probs, t, side="left")) / num_scans
        for t in thresholds
    ]
    order = np.argsort(fppi)
    fppi = np.asarray(fppi)[order]
    sens = np.asarray(sens)[order]
    froc = {
        str(f): float(np.interp(f, fppi, sens, left=0.0, right=sens[-1]))
        for f in FPPI_POINTS
    }
    cpm = float(np.mean(list(froc.values())))
    return {"cpm": cpm, "froc": froc, "num_annotations": int(n_ann),
            "num_scans": int(num_scans), "num_fps": int(len(fp_probs))}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--source", type=str, help="LUNA16 root (subset*/, annotations.csv)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--export-cpm", nargs=3, metavar=("PRED_DIR", "LABELS_DIR", "OUT_CSV"))
    p.add_argument("--score-cpm", nargs=2, metavar=("PRED_CSV", "ANNOTATIONS_CSV"))
    p.add_argument("--num-scans", type=int, default=None)
    p.add_argument(
        "--series-csv", type=str, default=None,
        help="csv of scored seriesuids (official seriesuids.csv semantics): "
        "restricts scoring to these scans — required when scoring a fold "
        "subset, else unscanned scans' nodules count as misses",
    )
    args = p.parse_args()
    if args.score_cpm:
        series = None
        if args.series_csv:
            with open(args.series_csv) as f:
                series = [
                    line.split(",")[0].strip()
                    for line in f
                    if line.strip() and not line.lower().startswith("seriesuid")
                ]
        result = score_cpm(*args.score_cpm, num_scans=args.num_scans, series=series)
        print(result)
        return
    if args.export_cpm:
        export_cpm(*args.export_cpm)
        return
    out = Path(args.out) if args.out else (
        Path(os.environ.get("det_data", ".")) / "Task016_Luna"
    )
    convert(Path(args.source), out)


if __name__ == "__main__":
    main()
