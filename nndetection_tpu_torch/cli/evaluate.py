"""Evaluate predictions against the GT (counterpart of ``nndet_eval``): box
metrics by default, plus ``--seg`` (per-case dice over exported seg maps),
``--case`` (patient-level AUROC/AP) and ``--analyze_boxes`` (the IoU x
score analysis grid with per-case overview CSVs)."""
from __future__ import annotations

import logging

from nndetection_tpu_torch.cli.common import (
    base_parser,
    resolve_cli_device,
    resolve_model_dir,
    resolve_task,
    setup_logging,
)
from nndetection_tpu_torch.pipeline import run_evaluate
from nndetection_tpu_torch.utils.config import compose

log = logging.getLogger("nndet")


def main() -> None:
    parser = base_parser("Evaluate predictions")
    parser.add_argument("--pred_dir", type=str, default=None)
    parser.add_argument("--split", type=str, default="Ts", choices=["Tr", "Ts"])
    parser.add_argument(
        "--boxes", dest="boxes", action="store_true", default=True,
        help="box evaluation (default on; --no-boxes to skip)",
    )
    parser.add_argument("--no-boxes", dest="boxes", action="store_false")
    parser.add_argument(
        "--seg", action="store_true",
        help="per-case foreground dice over exported *_seg.npz maps",
    )
    parser.add_argument(
        "--case", action="store_true",
        help="patient-level AUROC/AP from per-class max box scores",
    )
    parser.add_argument(
        "--analyze_boxes", action="store_true",
        help="full IoU x score analysis grid (plots, confusion, per-case "
        "overview CSV, worst-case ids)",
    )
    args = parser.parse_args()
    cfg = compose(overrides=args.overrides)
    device = resolve_cli_device(cfg)
    task_dir = resolve_task(args.task)
    model_dir = resolve_model_dir(task_dir, cfg["module"], cfg["plan"])
    pred_dir = args.pred_dir or (model_dir / "test_predictions")
    setup_logging(model_dir / "eval.log")

    from nndetection_tpu_torch.data.dataset import DatasetInfo

    info = DatasetInfo.from_file(task_dir / "dataset.yaml")
    classes = [str(info.labels[k]) for k in sorted(info.labels)]
    gt_dir = task_dir / "preprocessed" / cfg["plan"] / f"labels{args.split}"

    if args.boxes:
        scores, _ = run_evaluate(task_dir, pred_dir, plan_id=cfg["plan"], split=args.split,
                                 device=device)
        for k, v in sorted(scores.items()):
            log.info(f"{k}: {v:.4f}")
    if args.seg:
        from nndetection_tpu_torch.evaluator.registry import evaluate_seg_dir

        seg_scores = evaluate_seg_dir(pred_dir, gt_dir, save_dir=pred_dir)
        for k, v in sorted(seg_scores.items()):
            log.info(f"{k}: {v:.4f}")
    if args.case:
        from nndetection_tpu_torch.evaluator.registry import evaluate_case_dir

        case_scores = evaluate_case_dir(pred_dir, gt_dir, classes,
                                        target_class=info.target_class, save_dir=pred_dir)
        for k, v in sorted(case_scores.items()):
            log.info(f"{k}: {v:.4f}")
    if args.analyze_boxes:
        from nndetection_tpu_torch.utils.analysis import run_analysis_suite

        run_analysis_suite(pred_dir, gt_dir, pred_dir / "analysis", num_classes=len(classes))
        log.info(f"analysis suite -> {pred_dir / 'analysis'}")


if __name__ == "__main__":
    main()
