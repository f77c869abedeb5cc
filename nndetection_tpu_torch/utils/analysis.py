"""Post-hoc analysis of a prediction directory on the host (copy of
:mod:`nndetection_tpu.utils.analysis`): prediction/GT joins at IoU/score
grids, confusion matrices, object-size statistics, and matplotlib plots
(FROC curves, score histograms, size scatter). matplotlib is optional: a
plot is skipped without it, and no number depends on it.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from nndetection_tpu_torch.core.boxes.ops_np import box_iou_np, box_size_np
from nndetection_tpu_torch.utils.io import load_pickle, save_json


def analyze_case(
    pred: Dict[str, np.ndarray],
    gt_boxes: np.ndarray,
    gt_classes: np.ndarray,
    iou_thresh: float = 0.1,
    score_thresh: float = 0.5,
) -> Dict:
    """Greedy-join predictions and GT; classify into TP/FP/FN with sizes."""
    pb = np.asarray(pred["pred_boxes"])
    ps = np.asarray(pred["pred_scores"])
    pl = np.asarray(pred["pred_labels"])
    keep = ps >= score_thresh
    pb, ps, pl = pb[keep], ps[keep], pl[keep]

    matched_gt = np.full(len(gt_boxes), -1)
    matched_pred = np.full(len(pb), -1)
    if len(pb) and len(gt_boxes):
        ious = box_iou_np(pb, gt_boxes)
        for i in np.argsort(-ps, kind="stable"):
            j = int(np.argmax(ious[i]))
            if ious[i, j] >= iou_thresh and matched_gt[j] == -1:
                matched_gt[j] = i
                matched_pred[i] = j
    tp = int((matched_pred >= 0).sum())
    fp = int((matched_pred == -1).sum())
    fn = int((matched_gt == -1).sum())
    # label confusion among matched pairs + matched IoUs for the joint plot
    confusion = []
    matched_ious = []
    for i, j in enumerate(matched_pred):
        if j >= 0:
            confusion.append((int(pl[i]), int(gt_classes[j])))
            matched_ious.append(float(ious[i, j]))
    tp_mask = matched_pred >= 0
    return {
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "confusion_pairs": confusion,
        "fn_sizes": box_size_np(gt_boxes[matched_gt == -1]).tolist()
        if fn
        else [],
        "tp_sizes": box_size_np(pb[tp_mask]).tolist() if tp else [],
        "fp_sizes": box_size_np(pb[~tp_mask]).tolist() if fp else [],
        "tp_scores": ps[tp_mask].tolist(),
        "fp_scores": ps[~tp_mask].tolist(),
        "matched_ious": matched_ious,
    }


def run_analysis_suite(
    pred_dir,
    gt_dir,
    save_dir,
    num_classes: int = 1,
    iou_threshs: Sequence[float] = (0.1, 0.5),
    score_threshs: Sequence[float] = (0.1, 0.5),
    make_plots: bool = True,
    top_n: int = 10,
    iou_thresh: Optional[float] = None,  # legacy single-threshold alias
) -> Dict:
    """Full (IoU x score) grid analysis: per-combination
    subdirectory with a per-case overview table, the worst-case id list,
    confusion matrix, joint matched-IoU/score plot and TP/FP/FN size
    histograms."""
    pred_dir, gt_dir, save_dir = Path(pred_dir), Path(gt_dir), Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    if iou_thresh is not None:
        iou_threshs = (iou_thresh,)
    summary: Dict = {}
    for it in iou_threshs:
        for st in score_threshs:
            sub = save_dir / f"iou_{it}_score_{st}"
            sub.mkdir(parents=True, exist_ok=True)
            agg = {"tp": 0, "fp": 0, "fn": 0}
            confusion = np.zeros((num_classes, num_classes), dtype=int)
            fn_sizes: List = []
            tp_sizes: List = []
            fp_sizes: List = []
            tp_scores: List = []
            fp_scores: List = []
            matched_ious: List = []
            matched_scores: List = []
            overview: Dict[str, Dict] = {}
            for p in sorted(pred_dir.glob("*_boxes.pkl")):
                # the metrics a box evaluation saved into this directory are
                # not a case's prediction (the JAX package reads them as one)
                if p.name == "results_boxes.pkl":
                    continue
                cid = p.name[: -len("_boxes.pkl")]
                pred = load_pickle(p)
                with np.load(gt_dir / f"{cid}_boxes_gt.npz") as f:
                    num_gt = int(len(f["classes"]))
                    res = analyze_case(
                        pred, f["boxes"], f["classes"], it, st
                    )
                for k in ("tp", "fp", "fn"):
                    agg[k] += res[k]
                overview[cid] = {k: res[k] for k in ("tp", "fp", "fn")}
                overview[cid]["num_gt"] = num_gt
                scores_arr = np.asarray(pred["pred_scores"])
                overview[cid]["num_pred"] = int(len(scores_arr))
                overview[cid]["num_pred_kept"] = int((scores_arr >= st).sum())
                overview[cid]["max_score"] = (
                    float(scores_arr.max()) if len(scores_arr) else 0.0
                )
                for pc, gc in res["confusion_pairs"]:
                    if pc < num_classes and gc < num_classes:
                        confusion[gc, pc] += 1
                fn_sizes.extend(res["fn_sizes"])
                tp_sizes.extend(res["tp_sizes"])
                fp_sizes.extend(res["fp_sizes"])
                tp_scores.extend(res["tp_scores"])
                fp_scores.extend(res["fp_scores"])
                matched_ious.extend(res["matched_ious"])
                matched_scores.extend(res["tp_scores"])
            # worst cases first (most missed + spurious)
            worst = sorted(
                overview, key=lambda c: -(overview[c]["fn"] + overview[c]["fp"])
            )[:top_n]
            save_json(overview, sub / "analysis.json")
            save_json({"worst_cases": worst}, sub / "analysis_ids.json")
            # per-case overview CSV
            import csv as _csv

            with open(sub / "overview.csv", "w", newline="") as fcsv:
                cols = ["case_id", "num_gt", "num_pred", "num_pred_kept",
                        "tp", "fp", "fn", "max_score"]
                w = _csv.writer(fcsv)
                w.writerow(cols)
                for cid in sorted(overview):
                    w.writerow([cid] + [overview[cid][c] for c in cols[1:]])
            key = f"iou_{it:.2f}_score_{st:.2f}"
            summary[key] = {
                **agg,
                "precision": agg["tp"] / max(agg["tp"] + agg["fp"], 1),
                "recall": agg["tp"] / max(agg["tp"] + agg["fn"], 1),
                "confusion": confusion.tolist(),
                "num_missed": len(fn_sizes),
            }
            if make_plots:
                _plot_hists(tp_scores, fp_scores, fn_sizes, sub, st)
                _plot_joint_iou_score(matched_ious, matched_scores, sub)
                _plot_sizes(tp_sizes, fp_sizes, fn_sizes, sub, it, st)
    save_json(summary, save_dir / "analysis.json")
    return summary


def convert_boxes_to_mask(
    pred_boxes: np.ndarray,
    pred_scores: np.ndarray,
    pred_labels: np.ndarray,
    shape: Sequence[int],
    score_thresh: float = 0.0,
) -> tuple:
    """Rasterize box predictions into an instance mask + per-instance meta
    for ``cli.utils.main_boxes2nii``'s visualization export."""
    mask = np.zeros(tuple(int(s) for s in shape), dtype=np.uint16)
    meta = {}
    iid = 0
    dim = len(shape)
    for box, score, label in zip(pred_boxes, pred_scores, pred_labels):
        if score < score_thresh:
            continue
        iid += 1
        sl = [
            slice(max(int(box[0]), 0), max(int(box[2]), 0)),
            slice(max(int(box[1]), 0), max(int(box[3]), 0)),
        ]
        if dim == 3:
            sl.append(slice(max(int(box[4]), 0), max(int(box[5]), 0)))
        mask[tuple(sl)] = iid
        meta[iid] = {"score": float(score), "label": int(label)}
    return mask, meta


def _plot_joint_iou_score(ious, scores, save_dir: Path):
    """Scatter of matched-pair IoU vs prediction score."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001
        return
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(ious, scores, s=8, alpha=0.5)
    ax.set_xlabel("matched IoU")
    ax.set_ylabel("prediction score")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_dir / "joint_iou_score.png", dpi=100)
    plt.close(fig)


def _plot_sizes(tp_sizes, fp_sizes, fn_sizes, save_dir: Path, iou, score):
    """TP/FP/FN histograms over summed box extents."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001
        return

    def extent(sizes):
        a = np.asarray(sizes)
        return a.sum(axis=1) if len(a) else np.zeros((0,))

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(
        [extent(tp_sizes), extent(fp_sizes), extent(fn_sizes)],
        bins=50,
        label=["tp", "fp", "fn"],
        color=["g", "r", "b"],
        histtype="step",
    )
    ax.set_title(f"IoU {iou} score {score}")
    ax.set_xlabel("box width + height (+ depth)")
    ax.set_ylabel("count")
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_dir / "sizes_bar.png", dpi=100)
    plt.close(fig)


def plot_froc_curves(curves: Dict, save_path) -> None:
    """Plot FROC curves from the evaluator's curve dict
    (``FROC_curve_IoU_*`` + ``FROC_fpi_thresholds``); does nothing without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001
        return
    fpi = curves.get("FROC_fpi_thresholds")
    if fpi is None:
        return
    fig, ax = plt.subplots(figsize=(6, 4))
    for k, v in curves.items():
        if k.startswith("FROC_curve_IoU_"):
            ax.plot(fpi, v, marker="o", label=k.replace("FROC_curve_", ""))
    ax.set_xscale("log", base=2)
    ax.set_xlabel("false positives per image")
    ax.set_ylabel("sensitivity")
    ax.set_ylim(0, 1.02)
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=120)
    plt.close(fig)


def _plot_hists(tp_scores, fp_scores, fn_sizes, save_dir: Path, score_thresh: float):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001
        return
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(
        [tp_scores, fp_scores], bins=20, label=["TP", "FP"], stacked=False
    )
    axes[0].set_title(f"scores (thr={score_thresh})")
    axes[0].legend()
    if fn_sizes:
        sizes = np.asarray(fn_sizes)
        axes[1].hist(sizes.max(axis=1), bins=20)
    axes[1].set_title("missed-object max extent")
    fig.tight_layout()
    fig.savefig(save_dir / f"analysis_scores_{score_thresh:.2f}.png", dpi=100)
    plt.close(fig)
