"""Directory-level evaluation (copy of
:mod:`nndetection_tpu.evaluator.registry`): ``{case}_boxes.pkl`` predictions
against ``{case}_boxes_gt.npz`` ground truth (box and case metrics), and
``{case}_seg.npz`` maps against ``{case}_seg_gt.npz`` (foreground dice)."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from nndetection_tpu_torch.evaluator.case import CaseEvaluator
from nndetection_tpu_torch.evaluator.det import BoxEvaluator
from nndetection_tpu_torch.utils.io import load_pickle, save_json, save_pickle


def _case_ids(pred_dir: Path):
    # the metrics a previous evaluation saved into this directory
    # (``results_boxes.pkl``) are not a case's prediction
    case_ids = sorted(p.name[: -len("_boxes.pkl")] for p in pred_dir.glob("*_boxes.pkl")
                      if p.name != "results_boxes.pkl")
    if not case_ids:
        raise FileNotFoundError(f"no *_boxes.pkl predictions in {pred_dir}")
    return case_ids


def evaluate_box_dir(
    pred_dir,
    gt_dir,
    classes: Sequence[str],
    save_dir=None,
    fast: bool = False,
    gt_suffix: str = "_boxes_gt.npz",
) -> Tuple[Dict[str, float], Dict]:
    """Evaluate all ``{case}_boxes.pkl`` in ``pred_dir`` against
    ``{case}{gt_suffix}`` in ``gt_dir``."""
    pred_dir, gt_dir = Path(pred_dir), Path(gt_dir)
    evaluator = BoxEvaluator.create(classes, fast=fast)
    for cid in _case_ids(pred_dir):
        pred = load_pickle(pred_dir / f"{cid}_boxes.pkl")
        with np.load(gt_dir / f"{cid}{gt_suffix}") as f:
            gt_boxes = f["boxes"]
            gt_classes = f["classes"]
        evaluator.add_batch(
            pred_boxes=[np.asarray(pred["pred_boxes"])],
            pred_scores=[np.asarray(pred["pred_scores"])],
            pred_labels=[np.asarray(pred["pred_labels"])],
            gt_boxes=[gt_boxes],
            gt_classes=[gt_classes],
        )
    scores, curves = evaluator.finish_online_evaluation()
    if save_dir is not None:
        save_dir = Path(save_dir)
        save_json(scores, save_dir / "results_boxes.json")
        save_pickle({"scores": scores, "curves": curves}, save_dir / "results_boxes.pkl")
        if curves:
            from nndetection_tpu_torch.utils.analysis import plot_froc_curves

            plot_froc_curves(curves, save_dir / "froc_curves.png")
    return scores, curves


def evaluate_case_dir(
    pred_dir,
    gt_dir,
    classes: Sequence[str],
    target_class: Optional[int] = None,
    save_dir=None,
    gt_suffix: str = "_boxes_gt.npz",
) -> Dict[str, float]:
    """Patient-level evaluation over a prediction directory: each case's
    detections reduce to per-class max box scores, scored against the
    GT-derived target."""
    pred_dir, gt_dir = Path(pred_dir), Path(gt_dir)
    evaluator = CaseEvaluator(classes, target_class=target_class)
    for cid in _case_ids(pred_dir):
        pred = load_pickle(pred_dir / f"{cid}_boxes.pkl")
        with np.load(gt_dir / f"{cid}{gt_suffix}") as f:
            gt_classes = f["classes"]
        evaluator.add_case(
            pred_scores=np.asarray(pred["pred_scores"]),
            pred_labels=np.asarray(pred["pred_labels"]),
            gt_classes=gt_classes,
        )
    scores = evaluator.finish_online_evaluation()
    if save_dir is not None:
        save_json(scores, Path(save_dir) / "results_case.json")
    return scores


def evaluate_seg_dir(pred_dir, gt_dir, save_dir=None) -> Dict[str, float]:
    """Per-case foreground dice over exported ``{case}_seg.npz`` maps."""
    pred_dir, gt_dir = Path(pred_dir), Path(gt_dir)
    dices = []
    for p in sorted(pred_dir.glob("*_seg.npz")):
        cid = p.name[: -len("_seg.npz")]
        with np.load(p) as f:
            pred = f["seg"]
        with np.load(gt_dir / f"{cid}_seg_gt.npz") as f:
            gt = f["seg"]
        tp = float(np.sum((pred > 0) & (gt > 0)))
        fp = float(np.sum((pred > 0) & (gt == 0)))
        fn = float(np.sum((pred == 0) & (gt > 0)))
        dices.append(2 * tp / max(2 * tp + fp + fn, 1e-8))
    scores = {"seg_dice_fg_mean": float(np.mean(dices)) if dices else 0.0}
    if save_dir is not None:
        save_json(scores, Path(save_dir) / "results_seg.json")
    return scores
